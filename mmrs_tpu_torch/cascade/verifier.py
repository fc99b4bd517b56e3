"""Pluggable VLM verifier stage.

Counterpart of mmrs_tpu/cascade/verifier.py: the prompt constants, the
yes-parse, StubVerifier and CallableVerifier are copies; LLaVAVerifier is
TPULLaVAVerifier's counterpart on the port's LLaVA (models/llava.py).

The reference's LLaVA gate (code/union_clip_llava2.py:104-130): prompt the
VLM "Does this image contain a {category}?", decode greedily at temperature
0, and treat the answer as positive iff "yes" appears in the lowercased
output (:127-130). SURVEY.md §7 stages the 7B VLM itself as a pluggable
interface (endpoint or stub) first; the cascade semantics live here so any
backend — a TPU-hosted VLM, an HTTP endpoint, or a test stub — slots in.
"""

from __future__ import annotations

from typing import Callable, Dict, Protocol

DEFAULT_PROMPT = "Does this image contain a {category}?"
STRICT_PROMPT = (
    "Does this image contain a {category}? "
    "Answer with ONLY a single word: 'yes' or 'no'."
)


def parse_yes_no(output: str) -> bool:
    """The reference's answer parse: `"yes" in output.lower()`
    (code/union_clip_llava2.py:127-130)."""
    return "yes" in output.lower()


def speculative_stats_of(verifier):
    """Duck-typed probe for a verifier's realized speculative acceptance
    (shared by `mmrs cascade` and /v1/stats): None unless the verifier
    exposes `speculative_stats()` and has decoded with a draft."""
    fn = getattr(verifier, "speculative_stats", None)
    return fn() if callable(fn) else None


class Verifier(Protocol):
    def verify(self, image_path: str, category: str) -> bool:
        """True iff the VLM confirms the image contains the category."""
        ...


class StubVerifier:
    """Deterministic test/bring-up stub: answers from a lookup, default yes.

    Keys: (image_path, category) first, then image_path alone."""

    def __init__(self, answers: Dict = None, default: bool = True):
        self.answers = answers or {}
        self.default = default
        self.calls: list = []

    def verify(self, image_path: str, category: str) -> bool:
        self.calls.append((image_path, category))
        if (image_path, category) in self.answers:
            return self.answers[(image_path, category)]
        if image_path in self.answers:
            return self.answers[image_path]
        return self.default


class CallableVerifier:
    """Adapts any `generate(image_path, prompt) -> str` function (an HTTP
    endpoint client, a local VLM decode loop) into the Verifier protocol,
    applying the reference prompt template and yes-parse."""

    def __init__(self, generate: Callable[[str, str], str],
                 prompt_template: str = DEFAULT_PROMPT):
        self.generate = generate
        self.prompt_template = prompt_template

    def verify(self, image_path: str, category: str) -> bool:
        prompt = self.prompt_template.format(category=category)
        return parse_yes_no(self.generate(image_path, prompt))


# LLaVA-v1.5 conversation framing used by the reference's eval_model call
# (code/union_clip_llava2.py:104-126): conv_mode=None with model name
# "llava-v1.5-7b" resolves to the llava_v1 template — system prompt +
# SeparatorStyle.TWO (sep " ", sep2 "</s>") — and the query is prefixed with
# "<image>\n". The rendered single-turn prompt is therefore
#   "{system} USER: <image>\n{query} ASSISTANT:"
# split at the <image> position into a pre-image and post-image text chunk
# (llava's tokenizer_image_token does the same split).
LLAVA_V1_SYSTEM = (
    "A chat between a curious human and an artificial intelligence "
    "assistant. The assistant gives helpful, detailed, and polite answers "
    "to the human's questions."
)
LLAVA_V15_PRE = LLAVA_V1_SYSTEM + " USER: "
LLAVA_V15_POST = " ASSISTANT:"


def llava_v1_prompt_parts(query: str,
                          system: str = LLAVA_V1_SYSTEM
                          ) -> "tuple[str, str]":
    """(pre_image_text, post_image_text) for the llava_v1 template.

    The newline between <image> and the query comes from llava's
    DEFAULT_IMAGE_TOKEN + "\\n" + qs framing, so it belongs to the
    post-image chunk."""
    return system + " USER: ", "\n" + query + LLAVA_V15_POST


class LLaVAVerifier:
    """The VLM verifier via models/llava.py, on one device or on a mesh.

    Needs: a LLaVA module (random, or from convert_jax.from_jax_llava), an
    LLaMA tokenizer exposing `encode(text) -> List[int]` and
    `decode(ids) -> str` (e.g. models/sentencepiece.SentencePieceBPE).
    Greedy decode at temperature 0; the answer is parsed with the
    reference's "yes"-substring test. The constructor is
    TPULLaVAVerifier's without `layers`; the kernel routes are
    `attn_impl` (the whole vision tower's, "auto" or "torch": K2, E1, E2
    and, with int8 weights, K6; it keeps the JAX option's name) and `attn`
    (the decoder's K10 / K11, in place of `decode_attn` / `prefill_attn`:
    models/llama.ATTN_ROUTES); `device` defaults to
    pipeline.default_device() and the models are moved there.

    `mesh` (parallel/mesh.Mesh with a model axis) hosts the decoder
    tensor-parallel (parallel/vlm.py): `params` is sharded there unless
    it is already placed (a vlm.MeshModel, e.g. vlm.llava_from_placed of
    a checkpoint), and a draft is sharded too when its shapes divide the
    model axis, else replicated; `shard_draft=True` on a draft that does
    not divide raises ValueError, False replicates it. A data axis wider
    than 1 splits each batch's rows: batches are padded to its width.
    """

    def __init__(self, params, cfg, tokenizer,
                 prompt_template: str = DEFAULT_PROMPT,
                 max_new_tokens: int = 32,
                 eos_token: int = 2,
                 image_size: int = 336,
                 compute_dtype=None,
                 attn_impl: str = "auto",
                 kv_dtype=None,
                 prefill_chunk: int | None = None,
                 decode_window: int | None = None,
                 early_stop: bool = True,
                 attn: str = "auto",
                 draft_params=None,
                 draft_cfg=None,
                 draft_tokens: int = 4,
                 device=None,
                 mesh=None,
                 shard_draft: bool | None = None):
        import threading

        import torch

        from mmrs_tpu_torch.pipeline import default_device

        self.mesh = mesh
        self.shard_draft = shard_draft
        self._tp_gen = None
        if mesh is not None:
            from mmrs_tpu_torch.parallel.mesh import first_device

            self.device = first_device(mesh)
        else:
            self.device = (torch.device(device) if device is not None
                           else default_device())
        self.params = (params.to(self.device) if mesh is None
                       else self._on_mesh(params, mesh))
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.prompt_template = prompt_template
        self.max_new_tokens = max_new_tokens
        self.eos_token = eos_token
        self.image_size = image_size
        self.compute_dtype = compute_dtype or torch.bfloat16
        self.attn_impl = attn_impl
        # int8 KV cache (llama.QKVCache): half the per-step KV bytes
        self.kv_dtype = kv_dtype
        self.prefill_chunk = prefill_chunk
        self.decode_window = decode_window
        # stop the decode once every row has answered (same tokens)
        self.early_stop = early_stop
        self.attn = attn
        # optional draft VLM: decode goes through models/speculative.py
        # (the same greedy output; decode_window does not apply there)
        self.draft_params = draft_params
        if draft_params is not None:
            self.draft_params = (draft_params.to(self.device)
                                 if mesh is None
                                 else self._draft_on_mesh(draft_params,
                                                          draft_cfg, mesh))
        self.draft_cfg = draft_cfg
        self.draft_tokens = draft_tokens
        # realized speculative acceptance, accumulated at collect()
        self._spec_lock = threading.Lock()
        self._spec_rounds = 0
        self._spec_tokens = 0
        self._spec_slots = 0

    @staticmethod
    def _on_mesh(params, mesh):
        from mmrs_tpu_torch.parallel.vlm import MeshModel, shard_llava_params

        return (params if isinstance(params, MeshModel)
                else shard_llava_params(params, mesh))

    def _draft_on_mesh(self, draft, draft_cfg, mesh):
        """The draft sharded when its decoder divides the model axis (or
        as `shard_draft` says), else replicated."""
        from mmrs_tpu_torch.parallel.vlm import (MeshModel,
                                                 draft_tp_divisible,
                                                 replicate_llama_params,
                                                 shard_llava_params)

        if isinstance(draft, MeshModel):
            return draft
        divisible = draft_tp_divisible((draft_cfg or draft.cfg).lm, mesh)
        if self.shard_draft is None:
            self.shard_draft = divisible
        elif self.shard_draft and not divisible:
            raise ValueError(
                "shard_draft=True but the draft's heads/kv-heads/mlp/vocab "
                "don't divide the mesh's model axis: use shard_draft=False "
                "(replicated draft)")
        return (shard_llava_params(draft, mesh) if self.shard_draft
                else replicate_llama_params(draft, mesh))

    def _tp_generate(self, images, pre, post):
        """The mesh's generate (parallel/vlm.py), built at first use."""
        if self._tp_gen is None:
            from mmrs_tpu_torch.parallel.vlm import (
                make_tp_llava_generate, make_tp_llava_speculative_generate)

            kw = dict(compute_dtype=self.compute_dtype, impl=self.attn_impl,
                      kv_dtype=self.kv_dtype, prefill_chunk=self.prefill_chunk,
                      attn=self.attn)
            if self.draft_params is not None:
                fn = make_tp_llava_speculative_generate(
                    self.cfg, self.draft_cfg, self.mesh, self.max_new_tokens,
                    self.draft_tokens, self.eos_token, return_stats=True,
                    **kw)
                self._tp_gen = lambda im, pr, po: fn(
                    self.params, self.draft_params, im, pr, po)
            else:
                fn = make_tp_llava_generate(
                    self.cfg, self.mesh, self.max_new_tokens, self.eos_token,
                    decode_window=self.decode_window,
                    early_stop=self.early_stop, **kw)
                self._tp_gen = lambda im, pr, po: (
                    fn(self.params, im, pr, po), None)
        return self._tp_gen(images, pre, post)

    def _generate(self, images, pre, post):
        """(tokens [B, max_new] on the device, speculative stats or None):
        nothing is fetched to the host here."""
        from mmrs_tpu_torch.models import llava

        if self.mesh is not None:
            return self._tp_generate(images, pre, post)
        kw = dict(compute_dtype=self.compute_dtype, impl=self.attn_impl,
                  kv_dtype=self.kv_dtype,
                  prefill_chunk=self.prefill_chunk, attn=self.attn)
        if self.draft_params is not None:
            return llava.generate_speculative(
                self.params, self.draft_params, images, pre, post,
                self.max_new_tokens, self.draft_tokens, self.eos_token,
                return_stats=True, **kw)
        return llava.generate(
            self.params, images, pre, post, self.max_new_tokens,
            self.eos_token, decode_window=self.decode_window,
            early_stop=self.early_stop, **kw), None

    def _record_spec(self, stats, batch_rows: int) -> None:
        """Fold one generate's speculative stats into the counters."""
        if stats is None or stats["rounds"] == 0:
            return
        # the first token per row comes free from the prefill: count only
        # round-emitted tokens, so a fully agreeing draft reads 1.0
        emitted = int(stats["emitted"].sum())
        tokens = max(emitted - batch_rows, 0)
        with self._spec_lock:
            self._spec_rounds += stats["rounds"]
            self._spec_tokens += tokens
            self._spec_slots += (stats["rounds"] * batch_rows
                                 * (self.draft_tokens + 1))

    def speculative_stats(self):
        """Realized speculative acceptance, or None without a draft or
        before any decode: `utilization` = round-emitted tokens / (rounds
        x batch x (k+1))."""
        with self._spec_lock:
            rounds, tokens, slots = (self._spec_rounds, self._spec_tokens,
                                     self._spec_slots)
        if self.draft_params is None or rounds == 0:
            return None
        return {
            "rounds": rounds,
            "tokens": tokens,
            "utilization": tokens / max(slots, 1),
        }

    def _load_image(self, image_path: str):
        """[1, S, S, 3] CLIP-normalized on the device (the hf stack; K3 on
        a card)."""
        import numpy as np
        import torch

        from mmrs_tpu_torch.io.images import load_image
        from mmrs_tpu_torch.ops.preprocess import normalize_images

        r = load_image(image_path, size=self.image_size, stack="hf")
        u8 = torch.from_numpy(np.array(r.pixels)[None]).to(self.device)
        return normalize_images(u8, dtype=self.compute_dtype)

    def _prompt_ids(self, prompt: str):
        """Tokenize the llava_v1 template around the <image> slot: BOS only
        on the pre-image chunk; the post-image chunk keeps the SP dummy
        prefix (HF legacy slow-tokenizer chunk encoding inside llava's
        tokenizer_image_token)."""
        pre_text, post_text = llava_v1_prompt_parts(prompt)
        try:
            pre_ids = self.tokenizer.encode(pre_text, add_bos=True)
            post_ids = self.tokenizer.encode(post_text, add_bos=False)
        except TypeError:  # tokenizer without the add_bos kwarg
            pre_ids = self.tokenizer.encode(pre_text)
            post_ids = self.tokenizer.encode(post_text)
        return pre_ids, post_ids

    def _ids(self, ids, rows: int):
        import torch

        return torch.tensor([ids] * rows, dtype=torch.long,
                            device=self.device)

    def _data_size(self) -> int:
        """Width of the mesh's data axis (batch rows must divide it)."""
        if self.mesh is None:
            return 1
        from mmrs_tpu_torch.parallel.mesh import data_size

        return data_size(self.mesh)

    def generate_text(self, image_path: str, prompt: str) -> str:
        pre_ids, post_ids = self._prompt_ids(prompt)
        images = self._load_image(image_path)
        # a data axis splits the batch: the one row is tiled over its
        # width (the data rows decode copies; row 0 is read)
        d = self._data_size()
        if d > 1:
            images = images.repeat(d, 1, 1, 1)
        out, spec = self._generate(images, self._ids(pre_ids, d),
                                   self._ids(post_ids, d))
        ids = [t for t in out[0].tolist() if t != self.eos_token]
        self._record_spec(spec, out.shape[0])
        return self.tokenizer.decode(ids)

    def verify(self, image_path: str, category: str) -> bool:
        prompt = self.prompt_template.format(category=category)
        return parse_yes_no(self.generate_text(image_path, prompt))

    def verify_batch_async(self, image_paths, category: str,
                           fixed_batch: int | None = None):
        """Queue one batched VQA decode and return a handle for `collect()`
        without fetching its result (the decode's own early-stop check and
        the speculative round check read one flag per step). The host
        then loads and gates the next chunk while the card decodes."""
        import torch

        if not image_paths:
            return ([], None, 0)
        n_real = len(image_paths)
        if fixed_batch is not None:
            if n_real > fixed_batch:
                raise ValueError(f"{n_real} paths > fixed_batch {fixed_batch}")
            image_paths = list(image_paths) + [image_paths[0]] * (
                fixed_batch - n_real)
        # a data axis splits the batch: pad it to the axis's width
        d = self._data_size()
        if len(image_paths) % d:
            image_paths = list(image_paths) + [image_paths[0]] * (
                d - len(image_paths) % d)
        prompt = self.prompt_template.format(category=category)
        pre_ids, post_ids = self._prompt_ids(prompt)
        images = torch.cat([self._load_image(p) for p in image_paths])
        b = images.shape[0]
        out, spec = self._generate(images, self._ids(pre_ids, b),
                                   self._ids(post_ids, b))
        return (out, spec, n_real)

    def collect(self, handle):
        """Fetch and parse a verify dispatch (see verify_batch_async)."""
        out, spec, n_real = handle
        if n_real == 0:
            return []
        results = []
        for row in out.tolist():
            ids = [t for t in row if t != self.eos_token]
            results.append(parse_yes_no(self.tokenizer.decode(ids)))
        self._record_spec(spec, len(results))
        return results[:n_real]

    def verify_batch(self, image_paths, category: str,
                     fixed_batch: int | None = None):
        """Batched VQA decode: one decode for all gate survivors (the same
        prompt for every image). `fixed_batch` pads the batch by repeating
        the first image, as the JAX verifier does for one compiled shape."""
        return self.collect(
            self.verify_batch_async(image_paths, category,
                                    fixed_batch=fixed_batch))
