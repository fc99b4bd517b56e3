from mmrs_tpu_torch.cascade.pipeline import CascadePipeline, CascadeResult  # noqa: F401
from mmrs_tpu_torch.cascade.verifier import (  # noqa: F401
    Verifier,
    StubVerifier,
    CallableVerifier,
    parse_yes_no,
)
