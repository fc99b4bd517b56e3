"""Tower configurations.

Presets mirror the model zoo the reference depends on (SURVEY.md §2.5):
  - OpenAI CLIP ViT-B/32 (clip.load("ViT-B/32"), code/test_clip.py:6)
  - HF openai/clip-vit-large-patch14 image tower (code/test_taiyi.py:17)
  - CLIP text transformer (both sizes)
  - IDEA-CCNL/Taiyi-CLIP-Roberta-large-326M-Chinese text tower, whose
    embedding is the BertForSequenceClassification `.logits` output — a
    768-d classification head used as a projection (code/test_taiyi.py:24).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class VITConfig:
    image_size: int = 224
    patch_size: int = 32
    width: int = 768
    layers: int = 12
    heads: int = 12
    embed_dim: int = 512          # output projection dim
    quick_gelu: bool = True       # OpenAI CLIP uses QuickGELU

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def seq_len(self) -> int:
        return self.grid * self.grid + 1  # patches + CLS


@dataclass(frozen=True)
class TextConfig:
    vocab_size: int = 49408
    context_length: int = 77
    width: int = 512
    layers: int = 12
    heads: int = 8
    embed_dim: int = 512
    quick_gelu: bool = True


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

# Tiny pair for tests/CI and smoke runs (full towers are slow to compile on
# the 1-core CPU the test mesh runs on).
VIT_TINY = VITConfig(image_size=224, patch_size=32, width=128, layers=2,
                     heads=4, embed_dim=64)
CLIP_TEXT_TINY = TextConfig(vocab_size=49408, context_length=77, width=128,
                            layers=2, heads=4, embed_dim=64)
TAIYI_TINY = BertConfig(hidden_size=64, layers=2, heads=2,
                        intermediate_size=128, num_labels=VIT_TINY.embed_dim)

IMAGE_TOWERS = {"vit_b32": VIT_B32, "vit_l14": VIT_L14, "vit_tiny": VIT_TINY}
TEXT_TOWERS = {
    "clip_text_b32": CLIP_TEXT_B32,
    "clip_text_l14": CLIP_TEXT_L14,
    "clip_text_tiny": CLIP_TEXT_TINY,
    "taiyi_roberta": TAIYI_ROBERTA_LARGE,
    "taiyi_tiny": TAIYI_TINY,
}
