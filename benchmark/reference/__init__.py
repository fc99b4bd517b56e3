"""The benchmark's plain reference: float32 PyTorch, TF32 off.

The towers follow their published descriptions (OpenAI CLIP's ViT and
text transformer, Taiyi's RoBERTa-large text tower), the scan is an exact
blocked cosine top-k, and the tokenizers are frozen copies of the CLIP
byte-level BPE and BERT WordPiece algorithms. Every function takes its
weights as a flat dict of tensors under the benchmark's names and its
inputs as the benchmark made them; nothing here imports the system under
test. `int8=True` is the control: every linear layer's input rows and
weight rows are rounded to int8 codes first.
"""

import torch


def no_tf32() -> None:
    """float32 products in float32 (the reference's precision)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
