"""Ops of the port: plain PyTorch formulations and kernel wrappers."""

from mamba_distributed_tpu_torch.ops.conv import causal_conv1d, causal_conv1d_update
from mamba_distributed_tpu_torch.ops.cuda.scan_kernels import selective_scan_kernel
from mamba_distributed_tpu_torch.ops.cuda.ssd_kernels import ssd_chunked_kernel
from mamba_distributed_tpu_torch.ops.norm import add_rms_norm, rms_norm, rms_norm_gated
from mamba_distributed_tpu_torch.ops.scan import (
    selective_scan,
    selective_scan_seq,
    selective_state_update,
)
from mamba_distributed_tpu_torch.ops.ssd import ssd_chunked, ssd_state_update

__all__ = [
    "add_rms_norm", "causal_conv1d", "causal_conv1d_update", "rms_norm",
    "rms_norm_gated", "selective_scan", "selective_scan_kernel", "selective_scan_seq",
    "selective_state_update", "ssd_chunked", "ssd_chunked_kernel", "ssd_state_update",
]
