"""Sequence parallelism for the Mamba mixers (counterpart of the JAX
package's ``parallel/seq_parallel.py``).

The sequence axis is cut over the mesh's ``seq`` ranks: each rank holds
the same batch rows and its own block of ``t / seq`` consecutive tokens,
runs the mixers on them, and only small boundary values cross ranks:

* the conv halo: each rank hands its last ``width - 1`` inputs to the
  next rank, which takes them as the conv's ``initial_state``
  (``sp_conv1d``);
* the SSD state (Mamba-2, ``sp_ssd``) and the selective-scan state
  (Mamba-1, ``sp_selective_scan``): each rank summarizes its block as
  (total decay, final state from a zero start); an exclusive prefix scan
  over the seq ranks (``_incoming_state``: log2(S) distance-doubling
  rounds, then a shift by one) gives every rank the state entering its
  block, and the block's output is made with that state as its seed.

Where the JAX package runs these under ``shard_map`` with ``ppermute``,
the port runs them on each rank with ``collectives.seq_shift``, an
autograd Function whose backward sends the gradient to the previous
rank.  Every seq rank issues the same exchanges in the same order,
forward and backward, so a block's recompute under remat repeats them on
every rank alike.

``ssm_impl="pallas"`` runs each rank's blocks through the hand-written
kernels: the SSD makes one unseeded pass (``ssd_fwd``, and ``ssd_chunk_states``
and ``ssd_bwd`` with the final state's cotangent in its backward) and adds
the incoming state's contribution as a linear correction
(``_seeded_correction``); the scan runs ``m1_scan`` twice, the second pass
seeded (its ``dh0`` carries the seed's gradient).
"""

from __future__ import annotations

import dataclasses

import torch

from mamba_distributed_tpu_torch.ops.conv import causal_conv1d
from mamba_distributed_tpu_torch.ops.cuda.scan_kernels import selective_scan_kernel
from mamba_distributed_tpu_torch.ops.cuda.ssd_kernels import ssd_chunked_kernel
from mamba_distributed_tpu_torch.ops.scan import _prep, selective_scan
from mamba_distributed_tpu_torch.ops.ssd import (
    _divisor_chunk,
    _mm,
    chunk_local,
    combine_chunk_outputs,
    cumsum,
    state_passing,
)
from mamba_distributed_tpu_torch.parallel.collectives import seq_shift


@dataclasses.dataclass(frozen=True)
class SeqContext:
    """What the sequence-parallel ops need of the seq group: the group,
    its size and this rank's index on it (it holds tokens ``[rank t/size,
    (rank + 1) t/size)`` of every row)."""

    group: object
    size: int
    rank: int


def check_no_decode_state_under_sp(seq, initial_conv_state, initial_ssm_state,
                                   return_final_state: bool) -> None:
    """Sequence parallelism is a training and eval path: a mixer's decode
    state carry is refused under it (JAX ``models/common.py:128-143``)."""
    if seq is not None and (initial_conv_state is not None or initial_ssm_state is not None
                            or return_final_state):
        raise ValueError(
            "sequence parallelism is a training/eval path: decode-state "
            "carry (initial states / return_final_state) is not supported "
            "under seq_ctx"
        )


def _shifted(seq: SeqContext, x: torch.Tensor) -> torch.Tensor:
    """The value from the previous seq rank (zeros into rank 0)."""
    return seq_shift(x, seq, 1)


def sp_conv1d(seq: SeqContext, x: torch.Tensor, weight: torch.Tensor,
              bias: torch.Tensor | None, activation: str | None = "silu",
              impl: str = "shift"):
    """Causal depthwise conv of this rank's block x (b, t_local, d), with
    the previous rank's last ``width - 1`` inputs as its initial state.
    Returns (y, None): a conv state means nothing under SP."""
    width = weight.shape[1]
    halo = None
    if width > 1:  # width 1 needs no halo
        if x.shape[1] < width - 1:
            raise ValueError(f"local sequence shard ({x.shape[1]}) shorter than the "
                             f"conv halo ({width - 1})")
        halo = _shifted(seq, x[:, -(width - 1):, :])
    return causal_conv1d(x, weight, bias, activation=activation, initial_state=halo,
                         impl=impl), None


def _incoming_state(seq: SeqContext, decay_total: torch.Tensor,
                    final_local: torch.Tensor) -> torch.Tensor:
    """The state entering this rank's block: the sum over ranks j < rank
    of final_j times the decays of the ranks between.

    An exclusive prefix scan over the seq ranks: log2(S) Hillis-Steele
    rounds of the pair combine (a, s) o (a', s') = (a a', s a' + s'), the
    received (left) value combined into the local one, then a shift by
    one, as in the JAX package.  A rank with no sender receives zeros,
    the combine's identity for s but not for a, so its a is patched to 1.
    Each round moves (a, s) in one exchange.  ``decay_total``
    broadcasts over ``final_local`` from the left."""
    n = seq.size
    if n == 1:
        return torch.zeros_like(final_local)
    a, s = decay_total, final_local
    bcast = (lambda v: v.reshape(v.shape + (1,) * (s.ndim - v.ndim)))
    d = 1
    while d < n:
        both = seq_shift(torch.cat([a.reshape(-1), s.reshape(-1)]), seq, d)
        a_in, s_in = both[:a.numel()].view(a.shape), both[a.numel():].view(s.shape)
        if seq.rank < d:
            a_in = torch.ones_like(a_in)
        s = s_in * bcast(a) + s
        a = a_in * a
        d *= 2
    return seq_shift(s, seq, 1)


def _seeded_correction(dt, A, C, s_in, chunk_size: int, compute_dtype):
    """The incoming state's contribution to a block's SSD output, which is
    linear in it: chunk c adds ``diag(e^a) C (prefix_c s_in)^T`` with
    ``prefix_c`` the product of the chunk decays before c.  The product in
    the compute dtype with fp32 accumulation; returns fp32 (b, t, h, p)."""
    b, t, g, n = C.shape
    h = dt.shape[-1]
    l = _divisor_chunk(t, chunk_size)
    nc = t // l
    hpg = h // g
    p = s_in.shape[2]

    dA = (dt.float() * A.float()).reshape(b, nc, l, h)
    a_cum = cumsum(dA, dim=2)                        # in-chunk log-decay
    chunk_sum = a_cum[:, :, -1, :]                   # (b, nc, h)
    # product of the chunk decays BEFORE chunk c (exclusive prefix)
    prefix = torch.exp(cumsum(chunk_sum, dim=1) - chunk_sum)
    e_a = torch.exp(a_cum)                           # (b, nc, l, h)

    s_eff = s_in.float()[:, None] * prefix[..., None, None]
    s_eff = s_eff.reshape(b, nc, g, hpg, p, n)       # head i -> (i // hpg, i % hpg)
    corr = _mm(C.reshape(b, nc, l, g, n), s_eff, "bclgn,bcgqpn->bclgqp", compute_dtype)
    corr = corr * e_a.reshape(b, nc, l, g, hpg)[..., None]
    return corr.reshape(b, t, h, p)


def sp_ssd(seq: SeqContext, x, dt, A, B, C, chunk_size: int, D=None,
           compute_dtype=torch.bfloat16, ssm_impl: str = "xla"):
    """The chunked SSD of this rank's block (shapes of ``ops/ssd.
    ssd_chunked``, t the local length), seeded with the state the earlier
    ranks' blocks leave.  Returns (y, None): the final state stays on the
    last rank.

    ``"xla"``: the plain chunk-local pass, this rank's summary, the
    exchange, then the state passing again seeded and the output
    assembly.  ``"pallas"``: one unseeded kernel pass gives both the
    block's output and its final state; the exchange, then the seed's
    linear correction added to the output in fp32."""
    if ssm_impl == "pallas":
        y0, final_local = ssd_chunked_kernel(x, dt, A, B, C, chunk_size=chunk_size, D=D,
                                             return_final_state=True,
                                             compute_dtype=compute_dtype)
        decay_total = torch.exp(torch.einsum("bth,h->bh", dt.float(), A.float()))
        s_in = _incoming_state(seq, decay_total, final_local)
        corr = _seeded_correction(dt, A, C, s_in, chunk_size, compute_dtype)
        return (y0.float() + corr).to(y0.dtype), None
    l = _divisor_chunk(x.shape[1], chunk_size)
    y_diag, states, chunk_decay, off_ctx = chunk_local(x, dt, A, B, C, l, compute_dtype)
    _, final_local = state_passing(states, chunk_decay)
    s_in = _incoming_state(seq, torch.prod(chunk_decay, dim=1), final_local)
    prev_states, _ = state_passing(states, chunk_decay, initial_state=s_in)
    return combine_chunk_outputs(y_diag, off_ctx, prev_states, x, D, compute_dtype), None


def sp_selective_scan(seq: SeqContext, u, dt, A, B, C, D=None, z=None, delta_bias=None,
                      delta_softplus: bool = False, ssm_impl: str = "xla"):
    """The Mamba-1 selective scan of this rank's block (shapes of
    ``ops/scan.selective_scan``), in two passes: the first from a zero
    state gives the block's final state, the exchange gives the state
    entering the block, and the second pass is the real scan seeded with
    it (both through ``m1_scan`` under ``"pallas"``).  Returns (y, None)."""
    scan = selective_scan_kernel if ssm_impl == "pallas" else selective_scan
    _, s_local = scan(u, dt, A, B, C, delta_bias=delta_bias, delta_softplus=delta_softplus,
                      return_final_state=True)
    _, df, Af, _, _, _ = _prep(u, dt, A, B, C, None, delta_bias, delta_softplus)
    # the block's elementwise decay exp(sum_t dt_t A) (b, d, n)
    decay_total = torch.exp(torch.einsum("btd,dn->bdn", df, Af))
    h_in = _incoming_state(seq, decay_total, s_local)
    return scan(u, dt, A, B, C, D=D, z=z, delta_bias=delta_bias,
                delta_softplus=delta_softplus, initial_state=h_in), None
