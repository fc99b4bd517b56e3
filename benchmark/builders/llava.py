"""The port's LLaVA verifier over the benchmark's weights (kind "llava").

`build` assembles `cascade.verifier.LLaVAVerifier` as `mmrs-torch cascade
--verifier llava` does (64-token prefill chunks through K10, K11 decode
steps, greedy), with the configuration's sizes: the port's `LLaVA` module
made on the meta device and loaded with the benchmark's device-made
tensors (`load_state_dict(assign=True)`, the names of
`reference/llava.weight_shapes`), and the port's SentencePiece tokenizer
over the benchmark's vocabulary. The control is the port's own int8
route, the CLI's `--verifier-int8`: int8 weights (`quantize_llava`) and
an int8 KV cache. The int8 KV cache alone, over bf16 weights, reads
within 1.3x of sound runs on the card, too near them to set a limit
between (PERF.md, section 2).

`replay` gives the logits the port computes for a pack's answer: the
verifier's own image load and prompt ids, then `llava.generate`'s calls
(the tower and projector, `llama.prefill` over the pack's right-sized
cache, one `llama.forward` a token) with the tokens the timed path
emitted in place of the argmax it took.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch


def configs(cfg: Dict):
    """The port's LLaVAConfig for the configuration file's sizes."""
    from mmrs_tpu_torch.models.configs import VITConfig
    from mmrs_tpu_torch.models.llama import LlamaConfig
    from mmrs_tpu_torch.models.llava import LLaVAConfig

    vis, lm, ver = cfg["vision_tower"], cfg["language_model"], cfg["verifier"]
    vcfg = VITConfig(image_size=vis["image_size"],
                     patch_size=vis["patch_size"],
                     width=vis["width"], layers=vis["layers"],
                     heads=vis["heads"], embed_dim=vis["embed_dim"],
                     quick_gelu=vis["activation"] == "quick_gelu")
    lcfg = LlamaConfig(vocab_size=lm["vocab_size"], dim=lm["hidden_size"],
                       layers=lm["num_hidden_layers"],
                       heads=lm["num_attention_heads"],
                       kv_heads=lm["num_key_value_heads"],
                       mlp_dim=lm["intermediate_size"],
                       rope_theta=lm["rope_theta"],
                       norm_eps=lm["rms_norm_eps"],
                       max_seq=lm["sliding_window"])
    return LLaVAConfig(vision=vcfg, lm=lcfg,
                       vision_feature_layer=ver["vision_feature_layer"],
                       drop_cls=ver["drop_cls"])


def build(cfg: Dict, traffic: Dict, weights: Dict[str, torch.Tensor],
          pieces: Sequence, device, control: bool = False):
    from mmrs_tpu_torch.cascade.verifier import LLaVAVerifier
    from mmrs_tpu_torch.models.llava import LLaVA
    from mmrs_tpu_torch.models.quantize import quantize_llava
    from mmrs_tpu_torch.models.sentencepiece import Piece, SentencePieceBPE

    if cfg["dtype"] != "bfloat16":
        raise ValueError(f"the verifier serves bfloat16, not {cfg['dtype']}")
    with torch.device("meta"):
        model = LLaVA(configs(cfg))
    model.load_state_dict(weights, strict=True, assign=True)
    model.requires_grad_(False)
    if control:
        quantize_llava(model)
    tok = SentencePieceBPE([Piece(*p) for p in pieces])
    lm = cfg["language_model"]
    if (tok.bos_id, tok.eos_id) != (lm["bos_token_id"], lm["eos_token_id"]):
        raise ValueError("the vocabulary's <s> and </s> are not the "
                         "configuration's")
    return LLaVAVerifier(
        model, model.cfg, tok, prompt_template=traffic["question"],
        max_new_tokens=traffic["max_new_tokens"], eos_token=tok.eos_id,
        image_size=cfg["vision_tower"]["image_size"],
        kv_dtype=torch.int8 if control else None,
        prefill_chunk=cfg["verifier"]["prefill_chunk"],
        early_stop=traffic["early_stop"], device=device)


@torch.inference_mode()
def replay(verifier, paths: List[str], category: str,
           tokens: torch.Tensor) -> torch.Tensor:
    """[B, n, V] f32: the logits from which the port took each of the n
    answer tokens `tokens` [B, n] of the pack (`paths`, `category`)."""
    from mmrs_tpu_torch.models import llama, llava

    v = verifier
    model = v.params
    pre, post = v._prompt_ids(v.prompt_template.format(category=category))
    images = torch.cat([v._load_image(p) for p in paths])
    b, n = tokens.shape
    img = llava.encode_images(model, images, v.compute_dtype, v.attn_impl)
    embeds = llava.build_multimodal_embeds(model, v._ids(pre, b), img,
                                           v._ids(post, b), v.compute_dtype)
    t = embeds.shape[1]
    cache_len = min(model.cfg.lm.max_seq, -(-(t + n) // 64) * 64)
    logits, cache = llama.prefill(model.lm, embeds, cache_len,
                                  v.compute_dtype, v.kv_dtype,
                                  v.prefill_chunk, v.attn)
    out = [logits[:, -1]]
    tok = tokens.to(embeds.device)
    for i in range(n - 1):
        logits, cache = llama.forward(
            model.lm, llama.embed_tokens(model.lm, tok[:, i:i + 1]), cache,
            t + i, v.compute_dtype, attn=v.attn)
        out.append(logits[:, -1])
    return torch.stack(out, 1).float()
