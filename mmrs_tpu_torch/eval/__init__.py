from mmrs_tpu_torch.eval.zeroshot import multiclass_zeroshot, binary_zeroshot  # noqa: F401
from mmrs_tpu_torch.eval.sweep import pair_threshold_sweep, write_sweep_csv  # noqa: F401
