"""The port's selective scan (Mamba-1) against the JAX package's, on the CPU.

* ``selective_scan_seq``, the chunked ``selective_scan`` and
  ``selective_state_update`` equal their JAX counterparts on the same
  numpy inputs (D, z, ``delta_bias`` with softplus, ``initial_state``,
  ``return_final_state``; d not a multiple of 128, t not a multiple of
  8) at fp32 1e-4: only the summation order differs;
* ``selective_scan_kernel`` (the plain kernel versions on a CPU tensor)
  equals the JAX ``selective_scan_pallas`` in interpret mode;
* ``SelectiveScanFunction``'s gradients of all six core inputs, ``dh0``
  under a final-state cotangent included, equal ``jax.grad`` through the
  JAX Pallas custom VJP (interpret mode, 2e-3 as tests/test_pallas.py)
  once, the JAX ``selective_scan``'s elsewhere, and torch autograd of the
  port's ``selective_scan_seq`` (1e-4);
* the plain kernel bodies: ``m1_entry_states_plain`` equals the states
  the oracle passes at the tile starts, ``m1_bwd_plain``'s summed
  partials equal autograd of the plain scan.

Two cases run JAX Pallas in interpret mode, each at the tiniest shape
(b 1, t 13, d 100, n 8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_distributed_tpu.ops import scan as jscan
from mamba_distributed_tpu.ops.pallas.scan_kernels import selective_scan_pallas
from mamba_distributed_tpu_torch.ops import scan
from mamba_distributed_tpu_torch.ops.cuda import scan_kernels as sk
from mamba_distributed_tpu_torch.ops.cuda.build import LAUNCHES

pytestmark = pytest.mark.torch

TOL = dict(atol=1e-4, rtol=1e-4)


def scan_inputs(seed, b=2, t=27, d=40, n=8):
    """u, delta (pre-softplus), dt = softplus(delta) > 0, A < 0, B, C, D,
    z, delta_bias, h0 as fp32 numpy arrays."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    delta = f(b, t, d) - 1.0
    return dict(u=f(b, t, d), delta=delta, dt=np.log1p(np.exp(delta)),
                A=-np.exp(rng.uniform(0.0, 2.5, (d, n))).astype(np.float32),
                B=f(b, t, n), C=f(b, t, n), D=f(d), z=f(b, t, d),
                delta_bias=0.1 * f(d), h0=0.5 * f(b, d, n))


def _core_keys(full: bool) -> tuple:
    """The scan's positional inputs: a raw delta under softplus when
    ``full``, else the positive dt itself."""
    return ("u", "delta" if full else "dt", "A", "B", "C")


def _kw(inp, full: bool):
    """Positional core + keyword extras of one call; ``full`` adds D, z,
    delta_bias with softplus and the initial state."""
    kw = dict(return_final_state=True)
    if full:
        kw.update(D=inp["D"], z=inp["z"], delta_bias=inp["delta_bias"],
                  delta_softplus=True, initial_state=inp["h0"])
    return [inp[k] for k in _core_keys(full)], kw


def fn_arg(v):
    return torch.from_numpy(v) if isinstance(v, np.ndarray) else v


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(got, ref):
    ref = _np(ref)
    return float(np.abs(_np(got) - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("name", ["selective_scan_seq", "selective_scan"])
@pytest.mark.parametrize("full", [False, True])
def test_scan_ops_match_jax(name, full):
    inp = scan_inputs(0)
    extra = dict(chunk_size=16) if name == "selective_scan" else {}  # t 27 -> chunks of 9
    core, kw = _kw(inp, full)
    yj, hj = getattr(jscan, name)(*map(jnp.asarray, core), **kw, **extra)
    yt, ht = getattr(scan, name)(*map(fn_arg, core), **{k: fn_arg(v) for k, v in kw.items()},
                                 **extra)
    np.testing.assert_allclose(_np(yt), np.asarray(yj), **TOL)
    np.testing.assert_allclose(_np(ht), np.asarray(hj), **TOL)


@pytest.mark.parametrize("full", [False, True])
def test_selective_state_update_matches_jax(full):
    inp = scan_inputs(1, b=3, t=1)
    args = [inp["h0"], inp["u"][:, 0], inp["delta"][:, 0], inp["A"], inp["B"][:, 0],
            inp["C"][:, 0]]
    kw = dict(D=inp["D"], z_t=inp["z"][:, 0], dt_bias=inp["delta_bias"]) if full else {}
    yj, hj = jscan.selective_state_update(*map(jnp.asarray, args),
                                          **{k: jnp.asarray(v) for k, v in kw.items()})
    state = torch.from_numpy(inp["h0"].copy())
    yt, ht = scan.selective_state_update(state, *map(fn_arg, args[1:]),
                                         **{k: fn_arg(v) for k, v in kw.items()}, out=state)
    assert ht is state  # in place
    np.testing.assert_allclose(_np(yt), np.asarray(yj), **TOL)
    np.testing.assert_allclose(_np(ht), np.asarray(hj), **TOL)


def test_kernel_forward_matches_jax_pallas():
    """One seeded interpret-mode case with D, z, softplus and a final
    state; t 13 and d 100 are padded by the JAX wrapper, not the port's."""
    inp = scan_inputs(2, b=1, t=13, d=100, n=8)
    core, kw = _kw(inp, True)
    yj, hj = selective_scan_pallas(*map(jnp.asarray, core),
                                   **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                                      for k, v in kw.items()}, interpret=True)
    before = dict(LAUNCHES)
    yt, ht = sk.selective_scan_kernel(*map(fn_arg, core),
                                      **{k: fn_arg(v) for k, v in kw.items()})
    assert LAUNCHES == before  # a CPU tensor takes the plain versions
    np.testing.assert_allclose(_np(yt), np.asarray(yj), **TOL)
    np.testing.assert_allclose(_np(ht), np.asarray(hj), **TOL)


# ---------------------------------------------------------------- gradients


def _cotangents(seed, b, t, d, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, d)).astype(np.float32),
            rng.standard_normal((b, d, n)).astype(np.float32))


def _grad_keys(full, seeded) -> list:
    return [*_core_keys(full), *(("D", "z", "delta_bias") if full else ()),
            *(("h0",) if seeded else ())]


def _jax_grads(fn, inp, full, seeded, dy, dfinal):
    """Gradients of <y, dy> (+ <hT, dfinal>) through the JAX ``fn``."""
    names = _grad_keys(full, seeded)

    def loss(args):
        kw = dict(return_final_state=True)
        if full:
            kw.update(D=args["D"], z=args["z"], delta_bias=args["delta_bias"],
                      delta_softplus=True)
        if seeded:
            kw["initial_state"] = args["h0"]
        y, hT = fn(*(args[k] for k in _core_keys(full)), **kw)
        out = jnp.sum(y * dy)
        return out + jnp.sum(hT * dfinal) if dfinal is not None else out

    return jax.grad(loss)({k: jnp.asarray(inp[k]) for k in names})


def _port_grads(fn, inp, full, seeded, dy, dfinal):
    names = _grad_keys(full, seeded)
    leaves = {k: torch.from_numpy(inp[k]).requires_grad_() for k in names}
    kw = dict(return_final_state=True)
    if full:
        kw.update(D=leaves["D"], z=leaves["z"], delta_bias=leaves["delta_bias"],
                  delta_softplus=True)
    if seeded:
        kw["initial_state"] = leaves["h0"]
    y, hT = fn(*(leaves[k] for k in _core_keys(full)), **kw)
    loss = (y * torch.from_numpy(dy)).sum()
    if dfinal is not None:
        loss = loss + (hT * torch.from_numpy(dfinal)).sum()
    loss.backward()
    return {k: v.grad for k, v in leaves.items()}


def test_function_grads_match_jax_pallas_vjp():
    """All six core inputs, dh0 under a final-state cotangent: the
    Function (plain kernel versions) against the JAX Pallas custom VJP."""
    inp = scan_inputs(3, b=1, t=13, d=100, n=8)
    dy, dfinal = _cotangents(4, 1, 13, 100, 8)
    jg = _jax_grads(lambda *a, **k: selective_scan_pallas(*a, **k, interpret=True),
                    inp, False, True, dy, dfinal)
    tg = _port_grads(sk.selective_scan_kernel, inp, False, True, dy, dfinal)
    assert set(tg) == set(jg) == {"u", "dt", "A", "B", "C", "h0"}
    for k in jg:
        assert _rel(tg[k], jg[k]) <= 2e-3, k


CASES = [  # (full, seeded, with dfinal, t, d)
    (False, False, False, 16, 64),
    (True, True, True, 27, 40),
    (True, False, True, 35, 70),
    (False, True, False, 9, 130),
]


@pytest.mark.parametrize("full,seeded,with_dfinal,t,d", CASES)
def test_function_grads_match_jax_xla(full, seeded, with_dfinal, t, d):
    inp = scan_inputs(5, b=2, t=t, d=d)
    dy, dfinal = _cotangents(6, 2, t, d, 8)
    dfinal = dfinal if with_dfinal else None
    jg = _jax_grads(jscan.selective_scan, inp, full, seeded, dy, dfinal)
    tg = _port_grads(sk.selective_scan_kernel, inp, full, seeded, dy, dfinal)
    assert set(tg) == set(jg)
    for k in jg:
        assert _rel(tg[k], jg[k]) <= 2e-3, k


@pytest.mark.parametrize("fn", ["selective_scan_kernel", "selective_scan"])
@pytest.mark.parametrize("full,seeded,with_dfinal,t,d", CASES)
def test_grads_match_torch_autograd_of_seq(fn, full, seeded, with_dfinal, t, d):
    """The Function and the chunked, rematerialized plain scan against
    autograd of the oracle, torch against torch."""
    inp = scan_inputs(7, b=2, t=t, d=d)
    dy, dfinal = _cotangents(8, 2, t, d, 8)
    dfinal = dfinal if with_dfinal else None
    impl = sk.selective_scan_kernel if fn == "selective_scan_kernel" else (
        lambda *a, **k: scan.selective_scan(*a, **k, chunk_size=8))
    got = _port_grads(impl, inp, full, seeded, dy, dfinal)
    ref = _port_grads(scan.selective_scan_seq, inp, full, seeded, dy, dfinal)
    for k in ref:
        assert _rel(got[k], ref[k]) <= 1e-4, k


# ------------------------------------------------------ plain kernel bodies


def _core(inp):
    """The fp32 core inputs after _prep (softplus of delta + bias)."""
    uf, df, Af, Bf, Cf, _ = scan._prep(*(torch.from_numpy(inp[k]) for k in (
        "u", "delta", "A", "B", "C")), None, torch.from_numpy(inp["delta_bias"]), True)
    return uf, df, Af, Bf, Cf


@pytest.mark.parametrize("t", [16, 37])
def test_entry_states_plain_matches_seq_states(t):
    inp = scan_inputs(9, b=2, t=t, d=40)
    uf, df, Af, Bf, Cf = _core(inp)
    h0 = torch.from_numpy(inp["h0"])
    states = sk.m1_entry_states_plain(uf, df, Af, Bf, h0)
    assert states.shape == (2, -(-t // sk.T_BLK), 40, 8)
    torch.testing.assert_close(states[:, 0], h0)
    for k in range(1, states.shape[1]):
        s = sk.T_BLK * k
        _, hk = scan.selective_scan_seq(uf[:, :s], df[:, :s], Af, Bf[:, :s],
                                        Cf[:, :s], initial_state=h0,
                                        return_final_state=True)
        torch.testing.assert_close(states[:, k], hk, **TOL)


@pytest.mark.parametrize("seeded,with_dfinal", [(False, False), (True, True)])
def test_bwd_plain_partials_match_autograd(seeded, with_dfinal):
    """m1_bwd_plain over ragged tiles (t 37, tiles of T_BLK 8) and ragged
    channel blocks (d 100, blocks of D_BLK 64): its partials, summed as the
    Function sums them, equal autograd of m1_scan_plain."""
    inp = scan_inputs(10, b=2, t=37, d=100)
    core = [v.clone().requires_grad_() for v in _core(inp)]
    h0 = torch.from_numpy(inp["h0"]).requires_grad_() if seeded else None
    dy, dfinal = (torch.from_numpy(v) for v in _cotangents(11, 2, 37, 100, 8))
    y, hT = sk.m1_scan_plain(*core, h0)
    loss = (y * dy).sum() + ((hT * dfinal).sum() if with_dfinal else 0.0)
    refs = torch.autograd.grad(loss, core + ([h0] if seeded else []))
    with torch.no_grad():
        states = sk.m1_entry_states_plain(*core[:4], h0)
        du, ddt, dA, dB, dC, dh0 = sk.m1_bwd_plain(
            *core, states, dy, dfinal if with_dfinal else None)
    assert (sk.T_BLK, sk.D_BLK) == (8, 64)
    assert dA.shape == (2, 100, 8) and dB.shape == dC.shape == (2, 2, 37, 8)
    got = [du, ddt, dA.sum(0), dB.sum(1), dC.sum(1)] + ([dh0] if seeded else [])
    for name, a, r in zip(("du", "ddt", "dA", "dB", "dC", "dh0"), got, refs):
        assert _rel(a, r) <= 1e-4, name


def test_kernel_output_has_grad_fn_and_counts_no_launch_on_cpu():
    inp = scan_inputs(12, b=1, t=5, d=16)
    core, kw = _kw(inp, True)
    before = dict(LAUNCHES)
    u = torch.from_numpy(inp["u"]).requires_grad_()
    y, hT = sk.selective_scan_kernel(u, *map(fn_arg, core[1:]),
                                     **{k: fn_arg(v) for k, v in kw.items()})
    assert y.grad_fn is not None and hT.grad_fn is not None
    (y.sum() + hT.sum()).backward()
    assert u.grad is not None and LAUNCHES == before
