"""The device mesh (counterpart of mmrs_tpu/parallel). Its data axis:
sharded gallery scans, the slot-sharded IVF, the dedup ring, sharded
embedding and multi-process row placement; its model axis: the
verifier's tensor-parallel decoder (`parallel.vlm`, imported on its
own)."""

from mmrs_tpu_torch.parallel.mesh import make_mesh, shard_rows, replicate  # noqa: F401
from mmrs_tpu_torch.parallel.topk import sharded_cosine_topk  # noqa: F401
from mmrs_tpu_torch.parallel.dedup import sharded_first_match  # noqa: F401
from mmrs_tpu_torch.parallel.multihost import (  # noqa: F401
    distributed_init,
    make_hybrid_mesh,
    process_local_rows,
)
