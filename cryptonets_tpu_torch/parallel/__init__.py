"""Scaling across processes and devices on `torch.distributed` (port of
`cryptonets_tpu/parallel/`).

The reference is single-process; the JAX package maps its parallel axes to
TPU meshes: the ciphertext record batch to a data-parallel axis (`batch`,
no communication until decrypt), the RNS limbs to a tensor-parallel axis
(`limb`, collectives at base conversion and key switching), and the layer
chain to a pipeline of devices.  Here the `batch` axis spans processes
(one rank a card; `distributed.run_ranks` starts them on one host), the
`limb` axis shards the RNS limbs with explicit collectives at every
cross-limb operation (`limbs.py`), and the pipeline runs its stages on
CUDA streams.
"""

from .mesh import make_mesh, shard_ciphertext_data, batch_sharding
from .distributed import (
    init_multihost,
    local_record_slice,
    global_ciphertext_batch,
)
from .limbs import LimbShard
from .pipeline import PipelineForward
