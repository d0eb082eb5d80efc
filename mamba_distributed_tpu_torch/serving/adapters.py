"""Multi-tenant LoRA serving: named adapters, a refcounted device cache
of their factors, and the factor pools one launch reads (counterpart of
``mamba_distributed_tpu/serving/adapters.py``).

One engine serves many fine-tuned variants of one base model at once:

  * an :class:`AdapterRegistry` holds up to ``cfg.lora_max_adapters``
    named adapters' low-rank ``{A (L, d_in, r), B (L, r, d_out)}``
    factors, per layer, over the ``linear``-routed projections
    ``_LORA_RULES`` names (the mixers' in/out/x projections, attention's
    ``wqkv`` and ``out_proj``, the MLP's ``fc1``/``fc2``);
  * an :class:`AdapterCache` keeps a bounded number of them on the
    engine's device, stacked per target into ``(L, slots + 1, d_in, r)``
    and ``(L, slots + 1, r, d_out)`` pools in the compute dtype.  Row 0
    is the all-zero "no adapter" entry.  Admission ``acquire``s a row as
    it reserves KV pages (and waits when every row is pinned), a
    refcount pins a row while a resident stream uses it, zero-ref rows
    are evicted least recently used first, and a double ``release``
    raises :class:`AdapterCacheError`;
  * the engine attaches the pools under each target's param dict
    (``attach_adapter_pools``) and binds the launch's per-row pool ids
    once per tick, prefill chunk or verify (``bind_adapter_ids``), so
    ``models/common.linear`` adds

        y = x @ W + (x @ A[ids]) @ B[ids]

    on its fp32 accumulator: slots running different adapters share one
    launch, and id-0 rows add an exact 0.

The ``alpha / rank`` weight is folded into the stored ``B`` at
registration, so the merged reference is ``W + A @ B`` (``merge``).  A
stream under adapter ``a`` matches a solo ``generate()`` on
``merge(params, a)`` up to the re-association of the sums: greedy
tokens agree exactly in fp32.  Int8 base weights with LoRA are refused
by the engine, as in the JAX package.

Tensors are torch; the registry keeps numpy fp32 factors on the host and
draws ``register_random``'s factors from numpy's ``default_rng`` with the
JAX package's seed, so both packages register the same adapter.
"""

from __future__ import annotations

import zlib
from collections import OrderedDict

import numpy as np
import torch


class AdapterError(RuntimeError):
    """Base of the named multi-tenant LoRA errors."""


class UnknownAdapterError(AdapterError, ValueError):
    """A request (or merge, or acquire) named an adapter the registry
    does not hold."""


class AdapterCacheError(AdapterError):
    """An adapter-slot accounting violation: a double release, or the
    release of an adapter never acquired.  Always a caller bug."""


class AdapterVersionError(AdapterError, ValueError):
    """A registration that would overwrite or roll back a version:
    versions are monotone per base name."""


def split_adapter_version(name: str) -> tuple[str, int | None]:
    """``"tenant@v3"`` -> ``("tenant", 3)``; a bare name -> ``(name,
    None)``.  Only a trailing ``@v<digits>`` is version syntax."""
    base, sep, tail = name.rpartition("@v")
    if sep and base and tail.isdigit():
        return base, int(tail)
    return name, None


def versioned_name(base: str, version: int) -> str:
    """Canonical registry key: v1 is the bare name, v2+ ``base@vN``."""
    return base if version == 1 else f"{base}@v{version}"


# path suffixes of the linear()-routed projection dicts that take LoRA
# factors (mamba1's dt_proj bypasses linear(); convs, the MoE router,
# norms and the SSM scalars are not targets)
_LORA_RULES: tuple[tuple[str, ...], ...] = (
    ("mixer", "in_proj"),
    ("mixer", "out_proj"),
    ("mixer", "x_proj"),
    ("mixer", "wqkv"),
    ("mlp", "fc1"),
    ("mlp", "fc2"),
)


def is_lora_target(names: list[str]) -> bool:
    """Does the param-dict path take LoRA factors?"""
    return any(tuple(names[-len(p):]) == p for p in _LORA_RULES)


def lora_targets(params: dict) -> "OrderedDict[str, tuple[int, int, int]]":
    """The adapter target table of a param tree: ``"a/b/c"`` path ->
    ``(n_stack, d_in, d_out)`` for every layer-stacked projection kernel
    ``_LORA_RULES`` names, in sorted-key walk order."""
    out: OrderedDict[str, tuple[int, int, int]] = OrderedDict()

    def walk(tree, names):
        if not isinstance(tree, dict):
            return
        if "kernel" in tree and not isinstance(tree["kernel"], dict) \
                and is_lora_target(names):
            shape = tuple(tree["kernel"].shape)
            if len(shape) == 3:  # (L, d_in, d_out): stacked, as served
                out["/".join(names)] = shape
            return
        for k in sorted(tree.keys()):
            walk(tree[k], names + [k])

    walk(params, [])
    if not out:
        raise ValueError(
            "no LoRA-targetable projections found in the param tree "
            "(expected layer-stacked mixer/MLP kernels)"
        )
    return out


def prefix_salt(adapter: str | None) -> bytes:
    """Prefix-cache key salt of one adapter identity: a carry depends on
    the adapter whose delta shaped it.  No adapter is ``b""``, so keys
    stay those of a LoRA-less engine."""
    if not adapter:
        return b""
    return b"adapter:" + adapter.encode("utf-8") + b":"


# ------------------------------------------------------------- registry


class AdapterRegistry:
    """Host-side table of named adapters' fp32 factors.

    Each entry maps a target path (``lora_targets``) to ``{"A": (L,
    d_in, r), "B": (L, r, d_out)}`` numpy fp32, with ``alpha / rank``
    folded into ``B``.  An adapter may cover a subset of the targets;
    the others add the zero delta.  One registry may back several
    engines, each with its own :class:`AdapterCache`."""

    def __init__(self, cfg, params: dict):
        if cfg.lora_max_adapters <= 0:
            raise ValueError(
                "AdapterRegistry needs cfg.lora_max_adapters > 0 "
                "(0 = multi-tenant LoRA off)"
            )
        self.cfg = cfg
        self.rank = cfg.lora_rank
        self.alpha = cfg.lora_alpha
        self.max_adapters = cfg.lora_max_adapters
        self.targets = lora_targets(params)
        self._adapters: "OrderedDict[str, dict]" = OrderedDict()
        # base name -> highest registered version (v1 under the bare name)
        self._versions: dict[str, int] = {}

    # ------------------------------------------------------------ lookup

    def __contains__(self, name: str) -> bool:
        return self.resolve(name) in self._adapters

    def __len__(self) -> int:
        return len(self._adapters)

    def names(self) -> list[str]:
        return list(self._adapters.keys())

    def resolve(self, name: str) -> str:
        """Canonical key of ``name``: a bare name -> its latest version,
        ``@v1`` -> the bare name, any other ``@vN`` -> itself.  Never
        raises; an unknown name misses in :meth:`factors`."""
        base, ver = split_adapter_version(name)
        if ver is None:
            cur = self._versions.get(name)
            return name if cur is None else versioned_name(name, cur)
        if ver == 1 and base in self._adapters:
            return base
        return name

    def latest(self, name: str) -> str:
        """The newest registered version of ``name``'s base; raises
        :class:`UnknownAdapterError` on an unknown base."""
        base, _ = split_adapter_version(name)
        cur = self._versions.get(base)
        if cur is None:
            raise UnknownAdapterError(
                f"unknown adapter base {base!r}: this registry holds "
                f"{self.names()}"
            )
        return versioned_name(base, cur)

    def version_of(self, name: str) -> int:
        """``@vN`` -> N; a bare name -> its current latest (1 if none)."""
        base, ver = split_adapter_version(name)
        if ver is not None:
            return ver
        return self._versions.get(base, 1)

    def factors(self, name: str) -> dict:
        """The adapter's stored (scaled) factors by target path; raises
        :class:`UnknownAdapterError` on a miss."""
        try:
            return self._adapters[self.resolve(name)]
        except KeyError:
            raise UnknownAdapterError(
                f"unknown adapter {name!r}: this registry holds "
                f"{self.names()} (register it first)"
            ) from None

    # ------------------------------------------------------ registration

    def register(self, name: str, factors: dict,
                 alpha: float | None = None) -> str:
        """Register ``factors`` (target path -> {"A", "B"} unscaled)
        under ``name``, checking shapes against the target table and
        folding ``alpha`` (default ``cfg.lora_alpha``) over the rank into
        the stored B.  A bare name registers its base's next version; an
        explicit ``name@vN`` at or below the latest raises
        :class:`AdapterVersionError`.  Returns the canonical name."""
        if not name:
            raise ValueError("adapter name must be non-empty")
        base, ver = split_adapter_version(name)
        cur = self._versions.get(base, 0)
        if ver is None:
            ver = cur + 1
        elif ver <= cur:
            raise AdapterVersionError(
                f"adapter {base!r} is at v{cur}; registering "
                f"{base}@v{ver} would "
                + ("overwrite it" if ver == cur else "roll it back")
                + " — versions are monotone (register the bare name "
                "for the next version)"
            )
        key = versioned_name(base, ver)
        if len(self._adapters) >= self.max_adapters:
            raise ValueError(
                f"registry full: cfg.lora_max_adapters="
                f"{self.max_adapters} adapters already registered"
            )
        scale = (self.alpha if alpha is None else float(alpha)) / self.rank
        stored: dict[str, dict] = {}
        for path, fac in factors.items():
            if path not in self.targets:
                raise ValueError(
                    f"adapter {name!r} names unknown target {path!r}; "
                    f"valid targets: {list(self.targets)}"
                )
            n, d_in, d_out = self.targets[path]
            A = np.asarray(fac["A"], np.float32)
            B = np.asarray(fac["B"], np.float32)
            if A.shape != (n, d_in, self.rank):
                raise ValueError(
                    f"adapter {name!r} target {path!r}: A shape "
                    f"{A.shape} != {(n, d_in, self.rank)} "
                    f"(cfg.lora_rank={self.rank})"
                )
            if B.shape != (n, self.rank, d_out):
                raise ValueError(
                    f"adapter {name!r} target {path!r}: B shape "
                    f"{B.shape} != {(n, self.rank, d_out)}"
                )
            stored[path] = {"A": A, "B": B * scale}
        if not stored:
            raise ValueError(
                f"adapter {name!r} covers no targets (empty factors)"
            )
        self._adapters[key] = stored
        self._versions[base] = ver
        return key

    def register_random(self, name: str, seed: int = 0,
                        scale: float = 0.05,
                        targets: list[str] | None = None) -> str:
        """Register a random adapter (tests, benchmarks): A ~ N(0,
        scale/r), B ~ N(0, scale), both nonzero so the delta is live from
        the first token.  The generator is seeded with crc32(name) + seed,
        as in the JAX package, so both draw the same factors."""
        rng = np.random.default_rng(
            (zlib.crc32(name.encode("utf-8")) + int(seed)) & 0xFFFFFFFF
        )
        fac = {}
        for path in (targets if targets is not None else self.targets):
            n, d_in, d_out = self.targets[path]
            fac[path] = {
                "A": rng.normal(0.0, scale / self.rank,
                                (n, d_in, self.rank)),
                "B": rng.normal(0.0, scale, (n, self.rank, d_out)),
            }
        return self.register(name, fac)

    # ----------------------------------------------------- merged weights

    def merge(self, params: dict, name: str) -> dict:
        """The parity reference: the fp32 master tree with each target
        kernel replaced by ``W + A @ B`` (the scale is inside the stored
        B), on the kernel's device.  A host kernel takes numpy's product,
        as the JAX package does; a card's takes the card's fp32 one."""
        fac = self.factors(name)

        def walk(tree, names):
            if not isinstance(tree, dict):
                return tree
            path = "/".join(names)
            if path in fac and "kernel" in tree:
                w = tree["kernel"]
                A, B = fac[path]["A"], fac[path]["B"]
                if w.device.type == "cpu":
                    kernel = torch.from_numpy(
                        w.detach().float().numpy()
                        + np.einsum("ndr,nro->ndo", A, B))
                else:
                    kernel = w.detach().float() + torch.bmm(
                        torch.from_numpy(A).to(w.device),
                        torch.from_numpy(B).to(w.device))
                return {**tree, "kernel": kernel}
            return {k: walk(v, names + [k]) for k, v in tree.items()}

        return walk(params, [])


def merge_adapter_params(params: dict, registry: AdapterRegistry,
                         name: str | None) -> dict:
    """``registry.merge``, with ``None`` (no adapter) -> the base params."""
    if not name:
        return params
    return registry.merge(params, name)


# ----------------------------------------------------------- file format


def save_adapter_file(path: str, factors: dict) -> None:
    """One adapter's unscaled factors as an ``.npz`` with keys
    ``"<target path>::A"`` / ``"::B"`` (the JAX package's format)."""
    flat = {}
    for tpath, fac in factors.items():
        flat[tpath + "::A"] = np.asarray(fac["A"], np.float32)
        flat[tpath + "::B"] = np.asarray(fac["B"], np.float32)
    np.savez(path, **flat)


def load_adapter_file(path: str) -> dict:
    """Inverse of :func:`save_adapter_file`."""
    out: dict[str, dict] = {}
    with np.load(path) as z:
        for key in z.files:
            tpath, _, part = key.rpartition("::")
            if part not in ("A", "B") or not tpath:
                raise ValueError(
                    f"{path}: key {key!r} is not '<target>::A|B'"
                )
            out.setdefault(tpath, {})[part] = z[key]
    for tpath, fac in out.items():
        if "A" not in fac or "B" not in fac:
            raise ValueError(f"{path}: target {tpath!r} missing A or B")
    return out


# --------------------------------------------------------- device cache


class AdapterCache:
    """Bounded device cache of adapter factor rows (see the module
    docstring): refcounts and an LRU of zero-ref residents over stacked
    factor pools in ``compute_dtype`` on ``device``.  Row 0 of every pool
    is the zero "no adapter" entry, never handed out nor written.

    ``acquire(name)`` returns the adapter's row (uploading its factors on
    a miss, evicting the least recently used zero-ref resident if no row
    is free) or ``None`` when every row is pinned.  ``release(name)``
    drops one holder; at zero the adapter stays resident until evicted.
    ``version`` bumps on every pool write."""

    def __init__(self, registry: AdapterRegistry, slots: int,
                 compute_dtype=torch.bfloat16, device=None, cut=None):
        if slots < 1:
            raise ValueError(f"need >= 1 adapter cache slot, got {slots}")
        self.registry = registry
        self.slots = slots
        self.dtype = compute_dtype
        self.device = torch.device("cpu" if device is None else device)
        r = registry.rank
        # ``cut(path, part, factor)``: this rank's part of one adapter's
        # (n, d_in, r) or (n, r, d_out) factor on a serving mesh (its
        # stage's layers; A's d_in rows beside a row-parallel kernel, B's
        # d_out columns beside a column-parallel one); None keeps it whole
        self._cut = cut or (lambda path, part, t: t)

        def pool(path, part, shape):
            n, *rest = self._cut(path, part, torch.empty(shape, device="meta")).shape
            return torch.zeros((n, slots + 1, *rest), dtype=self.dtype, device=self.device)

        self.pools: dict[str, dict] = {
            path: {"A": pool(path, "A", (n, d_in, r)), "B": pool(path, "B", (n, r, d_out))}
            for path, (n, d_in, d_out) in registry.targets.items()
        }
        self.version = 0  # bumps on every pool write
        self._slot_of: dict[str, int] = {}  # resident adapter -> row
        self._refs: dict[str, int] = {}  # resident adapter -> holders
        self._lru: "OrderedDict[str, None]" = OrderedDict()  # zero-ref
        self._free: list[int] = list(range(1, slots + 1))
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    # -------------------------------------------------------------- state

    @property
    def resident_count(self) -> int:
        return len(self._slot_of)

    def resident(self, name: str) -> bool:
        """Is the adapter's factor set on the device now?  A pure probe."""
        return name in self._slot_of

    def resident_names(self) -> list[str]:
        return sorted(self._slot_of)

    def slot_of(self, name: str) -> int | None:
        return self._slot_of.get(name)

    def refcount(self, name: str) -> int:
        return self._refs.get(name, 0)

    @property
    def nbytes_per_adapter(self) -> int:
        """Device bytes of one adapter's factor rows across every target."""
        return sum(p.numel() // p.shape[1] * p.element_size()
                   for pool in self.pools.values() for p in pool.values())

    # ---------------------------------------------------------- lifecycle

    def acquire(self, name: str) -> int | None:
        """Pin ``name``'s factors to a row and return it (>= 1), or
        ``None`` when every row is pinned (the caller waits).  Unknown
        names raise :class:`UnknownAdapterError` before any state
        changes.  A wait is not a miss: a miss is one upload."""
        factors = self.registry.factors(name)  # raises on unknown
        slot = self._slot_of.get(name)
        if slot is not None:
            self.hits += 1
            self._refs[name] = self._refs.get(name, 0) + 1
            self._lru.pop(name, None)
            return slot
        if self._free:
            slot = self._free.pop(0)
        else:
            victim = next(iter(self._lru), None)
            if victim is None:
                return None
            self._lru.pop(victim)
            slot = self._slot_of.pop(victim)
            self._refs.pop(victim, None)
            self.evictions += 1
            # no scrub: the upload writes every target's rows (zeros for
            # targets the adapter does not cover)
        self.misses += 1
        self._upload(slot, factors)
        self._slot_of[name] = slot
        self._refs[name] = 1
        return slot

    def release(self, name: str) -> None:
        """Drop one holder; at zero the adapter stays resident and joins
        the LRU.  Releasing an adapter with no holders raises
        :class:`AdapterCacheError`."""
        rc = self._refs.get(name, 0)
        if name not in self._slot_of or rc <= 0:
            raise AdapterCacheError(
                f"release of adapter {name!r} with no holders "
                f"(double release, or never acquired)"
            )
        if rc == 1:
            self._refs[name] = 0
            self._lru[name] = None
            self._lru.move_to_end(name)
        else:
            self._refs[name] = rc - 1

    # ------------------------------------------------------------ uploads

    def _upload(self, slot: int, factors: dict) -> None:
        """Write one adapter's factors into row ``slot`` of every pool:
        one host-to-device copy per target and factor, explicit zeros
        for the targets the adapter does not cover."""
        for path, pool in self.pools.items():
            fac = factors.get(path)
            for part in ("A", "B"):
                row = pool[part][:, slot]
                if fac is None:
                    row.zero_()
                else:
                    row.copy_(self._cut(path, part, torch.from_numpy(fac[part])).to(
                        self.device, self.dtype))
        self.version += 1


# ----------------------------------------------- param-tree integration


def attach_adapter_pools(params: dict, pools: dict) -> dict:
    """The param tree with ``"lora": {"A": pool, "B": pool}`` added to
    each target's projection dict (the pools themselves, not copies:
    uploads write them in place)."""

    def walk(tree, names):
        if not isinstance(tree, dict):
            return tree
        path = "/".join(names)
        if path in pools:
            return {**tree, "lora": dict(pools[path])}
        return {k: walk(v, names + [k]) for k, v in tree.items()}

    return walk(params, [])


def bind_adapter_ids(params: dict, ids: torch.Tensor) -> dict:
    """The param tree with the launch's (b,) row -> pool-row ids bound
    into every attached ``"lora"`` dict, broadcast (a view) over the
    layer axis so ``models/lm._unstack`` hands each layer its copy.
    The engine binds once per tick, prefill chunk or verify: the ids do
    not change inside one.  Trees without ``"lora"`` pass through."""

    def walk(tree):
        if not isinstance(tree, dict):
            return tree
        lora = tree.get("lora")
        if isinstance(lora, dict) and "A" in lora:
            n = lora["A"].shape[0]
            return {
                **{k: walk(v) for k, v in tree.items() if k != "lora"},
                "lora": {**lora, "ids": ids[None, :].expand(n, ids.shape[0])},
            }
        return {k: walk(v) for k, v in tree.items()}

    return walk(params)
