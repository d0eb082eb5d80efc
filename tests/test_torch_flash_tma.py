"""The flash wrappers' TMA layout check (``flash_kernels.tma_layout_problem``
and ``check_tma_layout``): the bf16 tensor-core kernels (forward, dq and
dk/dv) read q, k, v and dO with TMA, which needs a 16-byte-aligned start
and (batch, head, time) strides that are multiples of 16 bytes.  On the
CPU the check is plain Python over shapes, strides and addresses; the
wrappers themselves run their plain versions on a CPU tensor and launch
nothing, unless a test forces the kernel route with a stand-in library
that must not be called."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mamba_distributed_tpu_torch.ops.cuda import flash_kernels as fk
from mamba_distributed_tpu_torch.ops.cuda.build import LAUNCHES

pytestmark = pytest.mark.torch


def _qkv_views(b, t, nh, nkv, hd, dtype=torch.bfloat16):
    """Head-major q, k, v as ``flash_sdpa_causal`` hands them to the
    kernels: transposed slices of one (b, t, (nh + 2 nkv) hd) projection,
    split as ``models/attention._split_qkv`` splits it."""
    rng = np.random.default_rng(0)
    qkv = torch.from_numpy(rng.standard_normal((b, t, (nh + 2 * nkv) * hd),
                                               dtype=np.float32)).to(dtype)
    q = qkv[..., :nh * hd].reshape(b, t, nh, hd)
    k = qkv[..., nh * hd:(nh + nkv) * hd].reshape(b, t, nkv, hd)
    v = qkv[..., (nh + nkv) * hd:].reshape(b, t, nkv, hd)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def _problem(t):
    return fk.tma_layout_problem(t.shape, t.stride(), t.element_size(), t.data_ptr())


@pytest.mark.parametrize("hd,nh,nkv", [(32, 4, 2), (64, 12, 4), (128, 8, 4)])
def test_tma_check_accepts_the_mixer_views(hd, nh, nkv):
    qt, kt, vt = _qkv_views(2, 40, nh, nkv, hd)
    assert not qt.is_contiguous() and kt.storage_offset() > 0
    for t in (qt, kt, vt):
        assert _problem(t) is None
    fk.check_tma_layout("flash_bwd_dkv", q=qt, k=kt, v=vt, dO=qt)


@pytest.mark.parametrize("shape", [(1, 4, 1, 64), (2, 3, 77, 32), (1, 1, 1, 128)])
def test_tma_check_accepts_contiguous_head_major(shape):
    t = torch.zeros(shape, dtype=torch.bfloat16)
    assert _problem(t) is None
    fk.check_tma_layout("flash_fwd", q=t, k=t, v=t)


def test_tma_check_refuses_an_unaligned_start():
    base = torch.zeros(1 + 2 * 3 * 16 * 64, dtype=torch.bfloat16)
    t = base[1:].reshape(2, 3, 16, 64)  # starts 2 bytes past the allocation
    assert t.data_ptr() % 16 == 2
    assert "16-byte boundary" in _problem(t)
    with pytest.raises(ValueError, match=r"flash_fwd: k cannot be read by TMA: its data starts "
                                         r"at byte 2 past a 16-byte boundary"):
        fk.check_tma_layout("flash_fwd", q=torch.zeros(2, 3, 16, 64, dtype=torch.bfloat16), k=t)


def test_tma_check_refuses_a_time_stride_off_16_bytes():
    # (b, t, h * hd + 1) rows: the time stride is 3 * 64 + 1 elements, 386 bytes
    x = torch.zeros(1, 10, 3 * 64 + 1, dtype=torch.bfloat16)
    t = x[..., :3 * 64].reshape(1, 10, 3, 64).transpose(1, 2)
    assert t.stride() == (10 * 193, 64, 193, 1)
    assert _problem(t) == ("its time stride is 193 elements (386 bytes), not a positive "
                           "multiple of 16 bytes")
    with pytest.raises(ValueError, match=r"flash_bwd_dkv: dO cannot be read by TMA: its time "
                                         r"stride is 193 elements \(386 bytes\)"):
        fk.check_tma_layout("flash_bwd_dkv", q=t.contiguous(), dO=t)


def test_tma_check_ignores_strides_of_unit_dims_and_refuses_a_strided_head_dim():
    t = torch.zeros(1, 1, 5, 64, dtype=torch.bfloat16).as_strided((1, 1, 5, 64), (3, 7, 64, 1))
    assert _problem(t) is None  # batch and head of extent 1 are never stepped
    wide = torch.zeros(2, 3, 8, 128, dtype=torch.bfloat16)[..., ::2]
    assert _problem(wide) == "its head dim has stride 2, not 1"


def test_wrappers_run_the_plain_versions_on_cpu_whatever_the_layout():
    """A CPU tensor never reaches the TMA check or a kernel: the wrappers
    give the plain versions' results and count no launch, even for a
    layout the tensor-core kernels would refuse."""
    b, t, nh, nkv, hd = 1, 24, 4, 2, 32
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((b, t, (nh + 2 * nkv) * hd + 1),
                                             dtype=np.float32)).to(torch.bfloat16)
    y = x[..., 1:]  # every slice starts 2 bytes off and has a 1 + 256-element time stride
    qt = y[..., :nh * hd].reshape(b, t, nh, hd).transpose(1, 2)
    kt = y[..., nh * hd:(nh + nkv) * hd].reshape(b, t, nkv, hd).transpose(1, 2)
    vt = y[..., (nh + nkv) * hd:].reshape(b, t, nkv, hd).transpose(1, 2)
    assert _problem(qt) is not None
    do = torch.from_numpy(rng.standard_normal((b, nh, t, hd), dtype=np.float32)).to(torch.bfloat16)
    before = dict(LAUNCHES)
    o, lse = fk.flash_fwd(qt, kt, vt, 0, t)
    o_p, lse_p = fk.flash_fwd_plain(qt, kt, vt, 0, t)
    delta = (do.float() * o_p.float()).sum(-1).contiguous()
    dk, dv = fk.flash_bwd_dkv(qt, kt, vt, do, lse_p, delta, 0, t)
    dk_p, dv_p = fk.flash_bwd_dkv_plain(qt, kt, vt, do, lse_p, delta, 0, t)
    assert LAUNCHES == before
    for a, r in ((o, o_p), (lse, lse_p), (dk, dk_p), (dv, dv_p)):
        torch.testing.assert_close(a, r, rtol=0, atol=0)


class _ShapesOnly:
    """A stand-in library: answers the wrappers' head-dim query and fails
    the test if a kernel would be launched."""

    def mdt_flash_supports(self, hd):
        return hd in fk.HEAD_DIMS

    def __getattr__(self, name):
        raise AssertionError(f"{name} was called")


def _bwd_args(dtype, bad: str, fault: str):
    """Backward arguments of the mixer's layout with one tensor, ``bad``,
    replaced by a copy that TMA cannot read: its start 2 bytes past a
    16-byte boundary, or its time stride 1 element off."""
    b, t, nh, nkv, hd = 1, 16, 4, 2, 32
    qt, kt, vt = _qkv_views(b, t, nh, nkv, hd, dtype)
    do = torch.zeros((b, nh, t, hd), dtype=dtype)
    named = {"q": qt, "k": kt, "v": vt, "dO": do}
    x = named[bad]
    shape = (x.shape[0], x.shape[2], x.shape[1], x.shape[3])  # (b, t, h, hd)
    if fault == "unaligned start":
        y = torch.zeros(1 + x.numel(), dtype=dtype)[1:].reshape(shape)
    else:
        y = torch.zeros(shape[:2] + (shape[2] * hd + 1,), dtype=dtype)[..., :-1]
        y = y.reshape(shape)
    named[bad] = y.transpose(1, 2)
    lse = torch.zeros((b, nh, t))
    return (named["q"], named["k"], named["v"], named["dO"], lse, lse.clone(), 0, t)


@pytest.mark.parametrize("wrapper", ["flash_bwd_dq", "flash_bwd_dkv"])
@pytest.mark.parametrize("bad,fault", [("q", "unaligned start"), ("k", "unaligned start"),
                                       ("v", "time stride"), ("dO", "unaligned start"),
                                       ("dO", "time stride")])
def test_backward_wrappers_refuse_layouts_tma_cannot_read(monkeypatch, wrapper, bad, fault):
    """Forced onto the kernel route, both bf16 backward wrappers refuse a
    tensor TMA cannot read, by name, before any launch."""
    monkeypatch.setattr(fk, "use_kernel", lambda impl, x: True)
    args = _bwd_args(torch.bfloat16, bad, fault)
    assert _problem(args[("q", "k", "v", "dO").index(bad)]) is not None
    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match=rf"{wrapper}: {bad} cannot be read by TMA"):
        getattr(fk, wrapper)(*args, lib=_ShapesOnly())
    assert LAUNCHES == before


@pytest.mark.parametrize("wrapper", ["flash_bwd_dq", "flash_bwd_dkv"])
def test_fp32_backward_takes_any_strides(monkeypatch, wrapper):
    """fp32 runs the CUDA-core kernels: the same layout passes the checks
    and reaches the launch (the stand-in library's kernel symbol)."""
    monkeypatch.setattr(fk, "use_kernel", lambda impl, x: True)
    args = _bwd_args(torch.float32, "dO", "time stride")
    with pytest.raises(AssertionError, match=rf"mdt_{wrapper} was called"):
        getattr(fk, wrapper)(*args, lib=_ShapesOnly())
