"""Multi-device: the row-sharded codec, data- and spatially parallel
training and rate, over ``torch.distributed`` (port of
``llicti_tpu/parallel``)."""
from .codec_sp import ShardedCodec, make_sp_mesh
from .distributed import initialize, local_batch_slice
from .eval import make_sharded_rate_fn
from .mesh import batch_sharding, make_mesh, replicated
from .train import make_parallel_train_step, shard_state
