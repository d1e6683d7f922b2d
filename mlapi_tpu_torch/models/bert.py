"""BERT encoder with a pooled-[CLS] classification head (counterpart of
``mlapi_tpu/models/bert.py``).

Numerics follow the JAX package: float32 parameters, embeddings,
LayerNorm (eps 1e-12) and residual stream; each block's matmuls in
``compute_dtype`` (inputs cast, float32 accumulation); exact GELU in
float32; the tanh pooler and the classifier in float32. Dropout is
omitted, as there.

The parameters mirror the JAX pytree: ``embeddings`` (``word``,
``position``, ``token_type``, ``ln_scale``, ``ln_bias``), ``pooler`` and
``classifier`` (``kernel [d_in, d_out]`` + ``bias``) and one submodule
per layer, ``layer_{n}``, holding ``q``, ``k``, ``v``, ``attn_out``,
``ffn_up``, ``ffn_down`` and ``ln1_*``/``ln2_*`` — so ``state_dict()``
keys are the JAX key paths with ``.`` for ``/`` and
``checkpoint.params_from_jax`` carries weights across unchanged.

``attention_impl="flash"`` runs attention through the B5-B7 kernels
(``ops/cuda/flash_attention``: forward and both backward kernels, so a
training step's attention never materialises the ``[B, H, L, L]``
scores); ``"full"`` is the plain softmax attention of ``ops/attention``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mlapi_tpu_torch.models import register_model
from mlapi_tpu_torch.models.gpt import _DTYPES, _Dense, _layer_norm
from mlapi_tpu_torch.ops.attention import full_attention
from mlapi_tpu_torch.ops.cuda.flash_attention import flash_attention
from mlapi_tpu_torch.ops.quant import take
from mlapi_tpu_torch.utils.platform import resolve_device

BERT_PRESETS = {
    # name: (vocab, hidden, layers, heads, intermediate, max_positions)
    "bert-base-uncased": (30522, 768, 12, 12, 3072, 512),
    "bert-large-uncased": (30522, 1024, 24, 16, 4096, 512),
    "bert-tiny": (30522, 128, 2, 2, 512, 512),
}

_LN_EPS = 1e-12  # BERT's LayerNorm epsilon


class _Embeddings(nn.Module):
    def __init__(self, v: int, h: int, positions: int, types: int):
        super().__init__()
        self.word = nn.Parameter(torch.zeros(v, h))
        self.position = nn.Parameter(torch.zeros(positions, h))
        self.token_type = nn.Parameter(torch.zeros(types, h))
        self.ln_scale = nn.Parameter(torch.ones(h))
        self.ln_bias = nn.Parameter(torch.zeros(h))


class _Layer(nn.Module):
    def __init__(self, h: int, i: int):
        super().__init__()
        self.q = _Dense(h, h)
        self.k = _Dense(h, h)
        self.v = _Dense(h, h)
        self.attn_out = _Dense(h, h)
        self.ln1_scale = nn.Parameter(torch.ones(h))
        self.ln1_bias = nn.Parameter(torch.zeros(h))
        self.ffn_up = _Dense(h, i)
        self.ffn_down = _Dense(i, h)
        self.ln2_scale = nn.Parameter(torch.ones(h))
        self.ln2_bias = nn.Parameter(torch.zeros(h))


@register_model("bert_classifier")
class BertClassifier(nn.Module):
    """BERT encoder with a pooled-[CLS] classification head.

    The constructor takes the JAX dataclass's fields (``bert_preset``
    overrides the sizes). Parameters are drawn from ``seed`` with the
    JAX package's distributions (normal 0.02 for embeddings and dense
    kernels, zero biases, unit LayerNorm scales) on the CPU, then moved
    to ``device`` (``utils/platform``: CUDA unless ``device="cpu"`` or
    ``MLAPI_TPU_PLATFORM=cpu``); ``seed=None`` skips the draw for
    weights about to be loaded. Every parameter trains.
    """

    input_kind = "text"  # token ids, not tabular features

    def __init__(
        self,
        num_classes: int = 2,
        bert_preset: str | None = None,
        vocab_size: int = 30522,
        hidden_size: int = 768,
        num_layers: int = 12,
        num_heads: int = 12,
        intermediate_size: int = 3072,
        max_positions: int = 512,
        type_vocab_size: int = 2,
        compute_dtype: str = "bfloat16",
        attention_impl: str = "full",
        *,
        seed: int | None = 0,
        device=None,
    ):
        super().__init__()
        if attention_impl == "ring":
            raise NotImplementedError(
                'attention_impl="ring" is not ported (sequence-parallel '
                "ring attention waits for ROADMAP Queue A item 8)"
            )
        if attention_impl not in ("full", "flash"):
            raise ValueError(f"unknown attention_impl {attention_impl!r}")
        if compute_dtype not in _DTYPES:
            raise ValueError(f"unsupported compute_dtype {compute_dtype!r}")
        dev = resolve_device(device)
        if bert_preset is not None:
            (vocab_size, hidden_size, num_layers, num_heads,
             intermediate_size, max_positions) = BERT_PRESETS[bert_preset]
        if hidden_size % num_heads:
            raise ValueError("hidden_size must divide evenly into heads")
        self.num_classes = num_classes
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.max_positions = max_positions
        self.compute_dtype = compute_dtype
        self.attention_impl = attention_impl

        h, i = hidden_size, intermediate_size
        self.embeddings = _Embeddings(vocab_size, h, max_positions,
                                      type_vocab_size)
        self.pooler = _Dense(h, h)
        self.classifier = _Dense(h, num_classes)
        for n in range(num_layers):
            self.add_module(f"layer_{n}", _Layer(h, i))
        if seed is not None:
            self._init_weights(int(seed))
        self.requires_grad_(True)
        self.to(dev)

    def _init_weights(self, seed: int) -> None:
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            emb = self.embeddings
            for table in (emb.word, emb.position, emb.token_type):
                table.normal_(0.0, 0.02, generator=gen)
            for mod in self.modules():
                if isinstance(mod, _Dense):
                    mod.kernel.normal_(0.0, 0.02, generator=gen)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def cdt(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    @property
    def device(self) -> torch.device:
        return self.embeddings.word.device

    def layer(self, n: int) -> _Layer:
        return getattr(self, f"layer_{n}")

    def encode(self, token_ids, attention_mask=None):
        """Token ids ``[B, L]`` → hidden states ``[B, L, H]`` (f32). The
        key mask defaults to ``ids != 0`` (the pad id)."""
        cdt = self.cdt
        b, l = token_ids.shape
        if attention_mask is None:
            attention_mask = token_ids != 0
        emb = self.embeddings
        pos = torch.arange(l, device=token_ids.device)
        x = (take(emb.word, token_ids) + take(emb.position, pos)[None]
             + take(emb.token_type, torch.zeros_like(token_ids)))
        x = _layer_norm(x, emb.ln_scale, emb.ln_bias, _LN_EPS)
        key_mask = attention_mask.to(torch.float32)
        nh, hd = self.num_heads, self.head_dim
        for n in range(self.num_layers):
            layer = self.layer(n)
            xc = x.to(cdt)
            q, k, v = (proj(xc, cdt).reshape(b, l, nh, hd)
                       for proj in (layer.q, layer.k, layer.v))
            if self.attention_impl == "flash":
                ctx = flash_attention(q, k, v, key_mask)
            else:
                ctx = full_attention(q, k, v, key_mask)
            attn = layer.attn_out(ctx.reshape(b, l, -1), cdt)
            x = _layer_norm(x + attn.to(torch.float32), layer.ln1_scale,
                            layer.ln1_bias, _LN_EPS)
            up = layer.ffn_up(x.to(cdt), cdt)
            up = F.gelu(up.to(torch.float32), approximate="none").to(cdt)
            down = layer.ffn_down(up, cdt)
            x = _layer_norm(x + down.to(torch.float32), layer.ln2_scale,
                            layer.ln2_bias, _LN_EPS)
        return x

    def apply(self, token_ids, attention_mask=None):
        """Token ids ``[B, L]`` → logits ``[B, num_classes]`` (f32): the
        tanh pooler over the [CLS] hidden state, then the classifier
        (HF ``BertForSequenceClassification`` semantics)."""
        cls = self.encode(token_ids, attention_mask)[:, 0, :]
        pooled = torch.tanh(self.pooler(cls, torch.float32))
        return self.classifier(pooled, torch.float32)

    forward = apply
