"""Weight-only int8 against float, in each package, on the same weights.

    JAX_PLATFORMS=cpu python -m tools.c5_int8_agreement [--dtype bfloat16]

A two-layer decoder at TinyLlama-1.1B's widths (hidden 2048, 32 query
heads on 4 KV heads, FFN 5632, vocabulary 32000), its weights drawn by
the JAX package's ``init`` from ``jax.random.key(0)`` and carried into
the PyTorch port with ``params_from_jax``. Eight sequences of 96
token ids drawn from ``numpy`` seed 0 run through each package's float
model and its ``QuantizedModel`` (one full causal forward each); the
next-token logits at positions 32-95 are compared: top-1 agreement of
int8 with float within each package, the largest and mean per-position
logit gap, and at each disagreement the float top-1 - top-2 margin
against the gap there. Prints one JSON object. A one-off reading for
the port's fault log (ROADMAP Queue C, C5), not a test; about 20 s and
4 GB of memory on a CPU.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def _stats(ref, got, start: int) -> dict:
    ref, got = ref[:, start - 1:-1], got[:, start - 1:-1]
    gap = np.abs(ref - got).max(-1)
    top2 = np.sort(ref, -1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    off = ref.argmax(-1) != got.argmax(-1)
    return {
        "top1_agreement": float(np.mean(~off)),
        "positions": int(off.size),
        "logit_gap_max": float(gap.max()),
        "logit_gap_mean": float(gap.mean()),
        "disagreements": int(off.sum()),
        "disagreement_margin_median":
            float(np.median(margin[off])) if off.any() else None,
        "disagreements_with_margin_below_gap":
            int((margin[off] < gap[off]).sum()),
    }


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--dtype", default="bfloat16",
                        choices=["bfloat16", "float32"])
    args = parser.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    from mlapi_tpu.models.llama import LlamaLM as JaxLlama
    from mlapi_tpu.models.quantized import QuantizedModel as JaxQuantized
    from mlapi_tpu.ops.quant import quantize_tree
    from mlapi_tpu_torch.checkpoint import params_from_jax
    from mlapi_tpu_torch.models.llama import LlamaLM
    from mlapi_tpu_torch.models.quantized import QuantizedModel

    cfg = dict(vocab_size=32000, hidden_size=2048, num_layers=2,
               num_heads=32, num_kv_heads=4, intermediate_size=5632,
               max_positions=2048, rope_theta=10000.0,
               compute_dtype=args.dtype)
    batch, length, start = 8, 96, 32
    jm = JaxLlama(**cfg)
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    ids = np.random.default_rng(0).integers(
        0, cfg["vocab_size"], (batch, length)).astype(np.int32)
    dev = jax.tree.map(jnp.asarray, params)
    jax_f = np.asarray(jm.apply(dev, jnp.asarray(ids)), np.float32)
    jax_q = np.asarray(JaxQuantized(jm).apply(
        jax.tree.map(jnp.asarray, quantize_tree(params)), jnp.asarray(ids)),
        np.float32)

    def port(quantize: bool):
        model = LlamaLM(**cfg, seed=None, device="cpu")
        model.load_state_dict(params_from_jax(params))
        model.requires_grad_(False)
        model = QuantizedModel(model) if quantize else model.cast_dense_()
        with torch.inference_mode():
            return model.apply(torch.as_tensor(ids).long()).float().numpy()

    port_f, port_q = port(False), port(True)
    print(json.dumps({
        "config": cfg, "batch": batch, "length": length,
        "scored_from": start,
        "jax_int8_vs_jax_float": _stats(jax_f, jax_q, start),
        "port_int8_vs_port_float": _stats(port_f, port_q, start),
        "port_float_vs_jax_float": _stats(jax_f, port_f, start),
        "port_int8_vs_jax_int8": _stats(jax_q, port_q, start),
    }, indent=1))


if __name__ == "__main__":
    main()
