"""Tower configurations.

Presets mirror the model zoo the reference depends on (SURVEY.md §2.5):
  - OpenAI CLIP ViT-B/32 (clip.load("ViT-B/32"), code/test_clip.py:6)
  - HF openai/clip-vit-large-patch14 image tower (code/test_taiyi.py:17)
  - CLIP text transformer (both sizes)
  - IDEA-CCNL/Taiyi-CLIP-Roberta-large-326M-Chinese text tower, whose
    embedding is the BertForSequenceClassification `.logits` output — a
    768-d classification head used as a projection (code/test_taiyi.py:24).
  - google/siglip-so400m-patch14-384 (Zhai et al. 2023, "Sigmoid Loss for
    Language Image Pre-Training"; the SoViT-400m shape of Alabdulmohsin et
    al. 2023): 729 patch tokens without a class token, a MAP pooling
    head, tanh GELU, an MLP of 4304, heads of 72; its bidirectional text
    tower pools the last token through a biased head.
"""

from __future__ import annotations

from dataclasses import dataclass
from dataclasses import replace as dataclass_replace
from typing import Optional, Tuple

from mmrs_tpu_torch.ops.preprocess import CLIP_MEAN, CLIP_STD

ACTIVATION_NAMES = ("quick_gelu", "gelu", "gelu_tanh")


@dataclass(frozen=True)
class VITConfig:
    image_size: int = 224
    patch_size: int = 32
    width: int = 768
    layers: int = 12
    heads: int = 12
    embed_dim: int = 512          # output projection dim (MAP pooling: width)
    quick_gelu: bool = True       # OpenAI CLIP uses QuickGELU
    # the MLP activation, one of ACTIVATION_NAMES; "" takes it from
    # `quick_gelu` (the JAX package's flag, whose configs load unchanged)
    activation: str = ""
    mlp_width: Optional[int] = None    # None: 4 x width
    layer_norm_eps: float = 1e-5
    patch_bias: bool = False           # the patch embedding's bias
    class_token: bool = True           # a CLS token before the patches
    pre_norm: bool = True              # ln_pre over the embedded tokens
    pool: str = "cls"                  # "cls": ln_post(CLS) @ proj; "map"
    mean: Tuple[float, float, float] = CLIP_MEAN   # K3's per-channel affine
    std: Tuple[float, float, float] = CLIP_STD
    stack: str = "openai"              # io/images.load_image's geometry

    @property
    def grid(self) -> int:
        """Patches a side; a remainder of image_size is cropped (a conv
        with "valid" padding)."""
        return self.image_size // self.patch_size

    @property
    def seq_len(self) -> int:
        return self.grid * self.grid + int(self.class_token)

    @property
    def act(self) -> str:
        return activation_of(self)

    @property
    def hidden(self) -> int:
        return self.mlp_width or 4 * self.width


@dataclass(frozen=True)
class TextConfig:
    vocab_size: int = 49408
    context_length: int = 77
    width: int = 512
    layers: int = 12
    heads: int = 8
    embed_dim: int = 512
    quick_gelu: bool = True
    activation: str = ""               # as VITConfig's
    mlp_width: Optional[int] = None    # None: 4 x width
    layer_norm_eps: float = 1e-5
    causal: bool = True                # False: bidirectional (SigLIP)
    pool: str = "eot"                  # "eot": the largest id; "last" token
    head_bias: bool = False            # a bias on text_projection

    @property
    def act(self) -> str:
        return activation_of(self)

    @property
    def hidden(self) -> int:
        return self.mlp_width or 4 * self.width


def activation_of(cfg) -> str:
    """A tower config's MLP activation name."""
    act = cfg.activation or ("quick_gelu" if cfg.quick_gelu else "gelu")
    if act not in ACTIVATION_NAMES:
        raise ValueError(f"unknown activation {act!r}; one of "
                         f"{ACTIVATION_NAMES}")
    return act


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 21128
    hidden_size: int = 1024
    layers: int = 24
    heads: int = 16
    intermediate_size: int = 4096
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    num_labels: int = 768         # Taiyi: logits double as the text embedding
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0


VIT_B32 = VITConfig(patch_size=32, width=768, layers=12, heads=12, embed_dim=512)
VIT_L14 = VITConfig(patch_size=14, width=1024, layers=24, heads=16, embed_dim=768)
# llava-v1.5's vision tower (openai/clip-vit-large-patch14-336): the L/14
# weights at 336px — 577 tokens; reference model, code/test_llava.py:6-13
VIT_L14_336 = VITConfig(image_size=336, patch_size=14, width=1024, layers=24,
                        heads=16, embed_dim=768)
CLIP_TEXT_B32 = TextConfig(width=512, layers=12, heads=8, embed_dim=512)
CLIP_TEXT_L14 = TextConfig(width=768, layers=12, heads=12, embed_dim=768)
TAIYI_ROBERTA_LARGE = BertConfig()
# google/siglip-so400m-patch14-384 (HF SiglipVisionConfig /
# SiglipTextConfig): 384 px at patch 14 is a 27 x 27 grid (the last 6
# pixel rows and columns are cropped), 1152 x 27, 16 heads of 72, MLP
# 4304, LayerNorm eps 1e-6, images resized to 384 x 384 with mean and std
# 0.5; the text tower: 32,000 ids, 64 positions, the same blocks
SIGLIP_SO400M_384 = VITConfig(
    image_size=384, patch_size=14, width=1152, layers=27, heads=16,
    embed_dim=1152, activation="gelu_tanh", mlp_width=4304,
    layer_norm_eps=1e-6, patch_bias=True, class_token=False,
    pre_norm=False, pool="map", mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5),
    stack="siglip")
SIGLIP_TEXT_SO400M = TextConfig(
    vocab_size=32000, context_length=64, width=1152, layers=27, heads=16,
    embed_dim=1152, activation="gelu_tanh", mlp_width=4304,
    layer_norm_eps=1e-6, causal=False, pool="last", head_bias=True)

# Tiny pair for tests/CI and smoke runs (full towers are slow to compile on
# the 1-core CPU the test mesh runs on).
VIT_TINY = VITConfig(image_size=224, patch_size=32, width=128, layers=2,
                     heads=4, embed_dim=64)
CLIP_TEXT_TINY = TextConfig(vocab_size=49408, context_length=77, width=128,
                            layers=2, heads=4, embed_dim=64)
TAIYI_TINY = BertConfig(hidden_size=64, layers=2, heads=2,
                        intermediate_size=128, num_labels=VIT_TINY.embed_dim)

# SigLIP's tiny pair keeps what the full one forces: heads of 72, a patch
# remainder (62 px at patch 14: a 4 x 4 grid, 6 pixels cropped), the MAP
# head, an MLP width that is not a multiple of the width
SIGLIP_TINY = dataclass_replace(
    SIGLIP_SO400M_384, image_size=62, width=144, layers=2, heads=2,
    embed_dim=144, mlp_width=152)
SIGLIP_TEXT_TINY = dataclass_replace(
    SIGLIP_TEXT_SO400M, vocab_size=512, context_length=16, width=144,
    layers=2, heads=2, embed_dim=144, mlp_width=152)

IMAGE_TOWERS = {"vit_b32": VIT_B32, "vit_l14": VIT_L14, "vit_tiny": VIT_TINY,
                "siglip_so400m_384": SIGLIP_SO400M_384,
                "siglip_tiny": SIGLIP_TINY}
TEXT_TOWERS = {
    "clip_text_b32": CLIP_TEXT_B32,
    "clip_text_l14": CLIP_TEXT_L14,
    "clip_text_tiny": CLIP_TEXT_TINY,
    "taiyi_roberta": TAIYI_ROBERTA_LARGE,
    "taiyi_tiny": TAIYI_TINY,
    "siglip_text_so400m": SIGLIP_TEXT_SO400M,
    "siglip_text_tiny": SIGLIP_TEXT_TINY,
}
