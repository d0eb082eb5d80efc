"""Token-shard data pipeline of the port (own copies of the JAX
package's ``data/loader.py`` and ``data/synthetic.py``)."""

from mamba_distributed_tpu_torch.data.loader import ShardedTokenLoader
from mamba_distributed_tpu_torch.data.synthetic import ensure_synthetic_shards

__all__ = ["ShardedTokenLoader", "ensure_synthetic_shards"]
