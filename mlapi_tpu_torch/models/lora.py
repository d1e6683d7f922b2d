"""LoRA (low-rank adaptation) for any model family (counterpart of
``mlapi_tpu/models/lora.py``).

Fine-tuning: :class:`LoraModel` wraps a model, freezes it
(``requires_grad=False``) and trains two small matrices per target
kernel, ``a [d_in, r]`` and ``b [r, d_out]``. Its forward runs the
frozen model on the merged weights ``W + (alpha/r)·a@b`` through
``torch.func.functional_call`` (the base detached, nothing copied), so
the optimizer holds only the adapters. ``b`` starts at zero, so step 0
is the base model exactly. ``merge_params`` folds the adapters into a
plain state dict that checkpoints and serves like any other.

Many-tenant serving keeps the base un-merged and applies per-request
adapters from a device slot pool (``serving/adapter_store.py``): the
models call :func:`lora_apply` after every dense projection, with the
layer's slice of the batch's adapter context passed explicitly through
``prefill_core`` / ``decode_step`` / ``extend_core`` (``lora=``). With
no context the call returns its ``y`` untouched: no op is added.
:func:`export_adapter` / :func:`merge_adapter` carry adapters across
the edges (a trained adapter to a serving payload; a payload folded
into plain weights, the merged reference).

The state dict mirrors the JAX tree ``{"base": ..., "lora":
{"layer_0/qkv": {"a", "b"}}}``: ``base.<inner key>`` and
``lora.layer_0/qkv.a``. The adapters' initial draws come from a
``torch.Generator`` (the JAX package folds its key per adapter), so a
seed gives other ``a`` matrices than JAX's; carried weights compute
the same thing.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

# Kernel-holding nodes adapted by default: every dense projection the
# decoder/encoder families register under these names. GPT/BERT hold
# them as ``{kernel, bias}`` modules, Llama as bare 2-D parameters.
DEFAULT_TARGETS = (
    "qkv", "attn_out", "ffn_up", "ffn_down",              # gpt / bert
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",   # llama
)


def _walk_targets(model: nn.Module, targets) -> list[tuple[str, str]]:
    """``(joined path, state-dict key of the kernel)`` of every adapted
    kernel, in registration order: a target-named module with a 2-D
    ``kernel`` parameter, or a target-named 2-D parameter."""
    out = []
    for path, mod in model.named_modules():
        for name, p in mod.named_parameters(recurse=False):
            if p.ndim != 2:
                continue
            owner = path.rsplit(".", 1)[-1] if path else ""
            if name == "kernel" and owner in targets:
                out.append((path.replace(".", "/"), f"{path}.kernel"))
            elif name in targets:
                key = f"{path}.{name}" if path else name
                out.append((key.replace(".", "/"), key))
    return out


class _Adapter(nn.Module):
    def __init__(self, a: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.a = nn.Parameter(a)
        self.b = nn.Parameter(b)


class LoraModel(nn.Module):
    """Low-rank adapters over a frozen model of any registered family.

    ``seed`` draws each ``a`` from ``N(0, 1/d_in)`` with one
    ``torch.Generator`` (``b`` is zero); every attribute the wrapper
    does not define is the inner model's."""

    def __init__(self, inner: nn.Module, rank: int = 8, alpha: float = 16.0,
                 targets=DEFAULT_TARGETS, *, seed: int = 0):
        super().__init__()
        if rank < 1:
            raise ValueError(f"LoRA rank must be >= 1, got {rank}")
        inner.requires_grad_(False)
        self.base = inner
        self.rank = int(rank)
        self.alpha = float(alpha)
        self.targets = tuple(targets)
        found = _walk_targets(inner, self.targets)
        if not found:
            raise ValueError(
                f"no LoRA targets found in {type(inner).__name__} "
                f"params (targets={self.targets})"
            )
        self._kernel_keys = dict(found)
        state = inner.state_dict()
        gen = torch.Generator().manual_seed(int(seed))
        self.lora = nn.ModuleDict()
        for joined, key in found:
            d_in, d_out = state[key].shape
            a = torch.randn(d_in, self.rank, generator=gen) / d_in**0.5
            self.lora[joined] = _Adapter(
                a.to(state[key].device),
                torch.zeros(self.rank, d_out, device=state[key].device),
            )

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            return getattr(self._modules["base"], name)

    @property
    def inner(self) -> nn.Module:
        return self.base

    @property
    def scale(self) -> float:
        return self.alpha / self.rank

    def trainable_mask(self) -> dict[str, bool]:
        """``{state-dict name: trains}``: only the adapters. The train
        loop hands the optimizer these parameters alone, so the frozen
        base gets no update and no moments (optax's ``masked``)."""
        return {n: n.startswith("lora.") for n, _ in self.named_parameters()}

    def _merged(self, detach_base: bool) -> dict[str, torch.Tensor]:
        """The adapted kernels, keyed as the inner state dict:
        ``W + (scale·a) @ b`` in the kernel's dtype."""
        params = dict(self.base.named_parameters())
        out = {}
        for joined, key in self._kernel_keys.items():
            w = params[key]
            if detach_base:
                w = w.detach()
            ab = self.lora[joined]
            out[key] = w + ((self.scale * ab.a) @ ab.b).to(w.dtype)
        return out

    def merge_params(self) -> dict[str, torch.Tensor]:
        """A PLAIN inner-model state dict with every adapter folded in
        (detached): it checkpoints and serves like the base model's."""
        with torch.no_grad():
            merged = self._merged(detach_base=True)
        return {k: merged.get(k, v).detach()
                for k, v in self.base.state_dict().items()}

    def apply(self, *args, **kwargs):
        """The inner model's ``apply`` on the merged weights; gradients
        reach the adapters alone."""
        return torch.func.functional_call(
            self.base, self._merged(detach_base=True), args, kwargs,
            strict=False,
        )

    forward = apply

    def param_shardings(self, layout=None):
        raise NotImplementedError(
            "LoRA parameter layouts on a device mesh are not ported "
            "(ROADMAP Queue A item 8)"
        )


# -- serving-side application (many-adapter slot pool) -----------------

def layer_lora(lora, n: int):
    """Layer ``n``'s slice of a batch's adapter context (``None`` when
    there is none)."""
    return None if lora is None else lora.get(f"layer_{n}")


def lora_apply(lora, target: str, x, y):
    """``y + x @ a @ b`` for a block matmul ``y = x @ W[target]`` when
    the layer's adapter context ``lora`` carries ``target``, else ``y``
    itself, with no op.

    The context (built by ``AdapterSlots.batch_params``) is ``{target:
    {"a": [S+1, d_in, r], "b": [S+1, r, d_out]}, ...}`` plus ONE
    marker: an int ``"slot"`` (a grouped batch, one tenant: a plain
    ``x @ a[slot] @ b[slot]``) or an int ``"rows"`` tensor ``[B]``
    (mixed tenants: the gathered BGMV of ``ops/bgmv.py``; base rows
    index the all-zero slot 0)."""
    if not lora:
        return y
    ab = lora.get(target)
    if ab is None:
        return y
    a, b = ab["a"], ab["b"]
    rows = lora.get("rows")
    if rows is not None:
        from mlapi_tpu_torch.ops.bgmv import bgmv

        return y + bgmv(x, a, b, rows)
    slot = lora["slot"]
    return y + (x @ a[slot].to(x.dtype)) @ b[slot].to(x.dtype)


def export_adapter(lora_params: dict, scale: float) -> dict:
    """Trained adapters (``{"layer_0/qkv": {"a", "b"}}``, tensors or
    arrays) → the CANONICAL serving payload ``{layer: {target: {a,
    b}}}`` of numpy arrays with ``b`` pre-scaled by alpha/rank, so the
    serving delta is exactly ``x @ a @ b``."""
    out: dict = {}
    for joined, ab in lora_params.items():
        path = joined.split("/")
        a, b = (_np(ab[k]) for k in ("a", "b"))
        out.setdefault(path[0], {})[path[-1]] = {
            "a": a, "b": np.asarray(scale * b),
        }
    return out


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x)


def merge_adapter(state: dict, payload: dict) -> dict:
    """A plain state dict with a serving payload folded in: ``W + a @
    b`` per target (``b`` already carries the scale), in each kernel's
    dtype. The merged-weights reference of the slot path, and the way
    to serve one tenant on an engine without adapter slots."""
    merged = dict(state)
    for ln, layer in payload.items():
        for target, ab in layer.items():
            key = f"{ln}.{target}.kernel"
            if key not in merged:
                key = f"{ln}.{target}"
            w = merged[key]
            delta = (torch.as_tensor(np.asarray(ab["a"]))
                     @ torch.as_tensor(np.asarray(ab["b"])))
            merged[key] = w + delta.to(w.device, w.dtype)
    return merged
