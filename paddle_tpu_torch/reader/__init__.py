from paddle_tpu_torch.reader.decorator import (  # noqa: F401
    map_readers, buffered, compose, chain, shuffle, firstn, xmap_readers,
    cache, double_buffer, super_batch, device_chunks,
    ElasticShardPlan, elastic_shard,
)
from paddle_tpu_torch.reader.batch import batch  # noqa: F401
