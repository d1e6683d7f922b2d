"""Hold the PyTorch port's kernels of this checkout against a parent
checkout on one CUDA card: the same bits where a kernel body did not
change, and timings with the two trees alternated.

    git archive PARENT_COMMIT | tar -x -C build/parent
    python3 -m mlapi_tpu_torch.tools.parent_ab --parent build/parent

Both trees build their kernels at once, each into its own ``build/``
(one line per tree names the kernels that ptxas says spill);
then every measurement runs in a process of its own that imports one
tree's ``mlapi_tpu_torch`` (the inputs and timers are this checkout's
``chip_smoke.py`` helpers, so both trees get the same ones):

1. same bits -- B1-B4 (every body, head dims 12-256, bf16, int8 and f32
   caches), B5 and B7 (out, lse, dk, dv) at every chip_smoke flash shape
   up to head dim 256, and B6 where its body is the CUDA-core one (f32,
   head dims past 128) on seeded inputs; the outputs of the two trees
   must be equal bit for bit;
2. kernels -- B1 and B3 at the serving decode shapes (B = 8, bf16, L =
   48 and 1024), and B5, B6 and B7 at chip_smoke's flash shapes (a)
   sst2-bert, (b) GPT-2 causal and (e) Llama-class: CUDA-graph ms and
   profiler device ms (B5-B7: the flash kernels alone), in the order
   parent, change, change, parent;
3. training -- one sst2-bert step (``chip_smoke.profile_train_step``):
   wall ms per step over ``--steps`` steps, device ms and kernels per
   step, in the same order;
4. decode -- ``chip_smoke.profile_decode`` of the float serving engines
   (the CLI's factory, flash) on seeded GPT-2 small (contiguous bf16,
   paged 16 int8) and TinyLlama-1.1B-width (contiguous bf16)
   checkpoints written once: kernels, device ms and wall ms per decode
   step at B = 8, in the same order.

``--sections`` picks some of them (default: all four).

One JSON line per measurement; exit 1 when an output differs or a
process fails. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
ORDER = ("parent", "change", "change", "parent")


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same_bits(cs, kern, torch, out_path):
    outs = {}
    cases = []
    for d, h, kvh in ((64, 12, 12), (128, 32, 8), (12, 8, 2), (32, 4, 4),
                      (160, 8, 4), (256, 8, 4)):
        for name in cs.SERVING:
            decode = name.endswith("decode_attention")
            u, pos = (1, 1023) if decode else (128, 768)
            for fmt in ("bf16", "int8", "f32") if decode else ("bf16", "int8"):
                cases.append((name, fmt, 4, u, 1024, pos, d, h, kvh))
        cases.append(("extend_attention", "f32", 2, 17, 300, 200, d, h, kvh))
    for i, (name, fmt, b, u, length, pos, d, h, kvh) in enumerate(cases):
        args = cs.kernel_case(name, fmt, b, u, length, pos, seed=i, h=h,
                              kvh=kvh, d=d)
        fn = getattr(kern, name)
        got = fn(*args[:5]) if name.startswith("paged_") else fn(*args)
        outs[f"{name} {fmt} D={d} H={h}/{kvh}"] = got.cpu()
    for shape in cs.flash_shapes(cs.sst2_first_batch()[2]):
        name, _, _, _, _, dtype, causal, window, _, d = shape
        if d > 256:
            continue          # past the parent's head dims
        cfg = dict(causal=causal, scale=d ** -0.5, window=window)
        q, k, v, mask, dout = cs.flash_inputs(shape, seed=5)
        out_p, lse_p = kern.flash_forward_plain(q, k, v, mask, **cfg)
        delta = (dout.float() * out_p.float()).sum(-1).transpose(1, 2)
        delta = delta.contiguous()
        if dtype == "float32" or d > 128:
            # B6's CUDA-core body (bf16 at D <= 128 is the new mma body).
            outs[f"B6 {name}"] = kern.flash_backward_dq(
                q, k, v, mask, dout, lse_p, delta, **cfg).cpu()
        out, lse = kern.flash_forward(q, k, v, mask, **cfg)
        dk, dv = kern.flash_backward_dkv(q, k, v, mask, dout, lse_p, delta,
                                         **cfg)
        outs.update({f"B5 out {name}": out.cpu(), f"B5 lse {name}": lse.cpu(),
                     f"B7 dk {name}": dk.cpu(), f"B7 dv {name}": dv.cpu()})
    torch.save(outs, out_path)


def _decode_kernels(cs, kern, label):
    for name in ("decode_attention", "paged_decode_attention"):
        fn = getattr(kern, name)
        for length in (48, 1024):
            sets = [cs.kernel_case(name, "bf16", 8, 1, length, length - 1,
                                   seed=300 + s) for s in range(8)]
            run = [(lambda a=a: fn(*a[:5])) for a in sets]
            print(json.dumps({
                "case": "kernel", "tree": label, "shape": f"B=8, L={length}",
                "kernel": name, "ms": cs.graph_ms(run, iters=240),
                "device_ms": cs.profiled_ms(run, iters=48),
            }), flush=True)


def _kernels(cs, kern, label):
    _decode_kernels(cs, kern, label)
    x0 = cs.sst2_first_batch()[2]
    shapes = {s[0]: s for s in cs.flash_shapes(x0)}
    for name in ("sst2-bert", "gpt2-causal", "llama-d128"):
        shape = shapes[name]
        d = shape[-1]
        cfg = dict(causal=shape[6], scale=d ** -0.5, window=shape[7])
        sets = []
        for s_i in range(4):
            q, k, v, mask, dout = cs.flash_inputs(shape, seed=200 + s_i)
            out, lse = kern.flash_forward(q, k, v, mask, **cfg)
            delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
            sets.append((q, k, v, mask, dout, lse, delta.contiguous()))
        calls = {
            "flash_forward": lambda a: kern.flash_forward(*a[:4], **cfg),
            "flash_backward_dq":
                lambda a: kern.flash_backward_dq(*a, **cfg),
            "flash_backward_dkv":
                lambda a: kern.flash_backward_dkv(*a, **cfg),
        }
        for which, fn in calls.items():
            run = [(lambda a=a: fn(a)) for a in sets]
            print(json.dumps({
                "case": "kernel", "tree": label, "shape": name,
                "kernel": which, "ms": cs.graph_ms(run, iters=60),
                "device_ms": cs.profiled_ms(run, iters=24, only="flash_"),
            }), flush=True)


def _train(cs, label, steps):
    import contextlib
    import io

    cfg, splits, _, _ = cs.sst2_first_batch()
    with contextlib.redirect_stdout(io.StringIO()):
        row = cs.profile_train_step(cfg, splits, runs=steps)
    print(json.dumps({
        "case": "train_step", "tree": label,
        "wall_ms_per_step": row["wall_ms_per_step"],
        "device_ms_per_step": row["device_ms_per_step"],
        "kernels_per_step": row["kernels_per_step"],
        "flash_ms_per_step": row["flash_ms_per_step"],
    }), flush=True)


DECODE_CASES = (("gpt2", None, None), ("gpt2", "int8", 16),
                ("tinyllama", None, None))


def _checkpoints(cs, out_dir):
    cs.make_checkpoint(Path(out_dir) / "gpt2")
    cs.make_llama_checkpoint(Path(out_dir) / "tinyllama")


def _decode(cs, label, ckpt_dir):
    import contextlib
    import io

    import torch

    from mlapi_tpu_torch.serving.__main__ import build_engine

    for name, kv_quant, page in DECODE_CASES:
        engine = build_engine(Path(ckpt_dir) / name, kv_quant=kv_quant,
                              decode_attn_impl="flash", kv_page_size=page)
        with contextlib.redirect_stdout(io.StringIO()) as text:
            cs.profile_decode(engine)
        row = json.loads(text.getvalue().splitlines()[-1])
        print(json.dumps({
            "case": "decode_step", "tree": label, "model": name,
            "kv_quant": kv_quant or "none", "kv_page_size": page,
            "wall_ms_per_step": row["wall_ms_per_step"],
            "device_ms_per_step": row["device_ms_per_step"],
            "kernels_per_step": row["kernels_per_step"],
        }), flush=True)
        del engine
        torch.cuda.empty_cache()


def worker(tree: str, label: str, task: str, arg: str) -> None:
    sys.path.insert(0, tree)
    import torch

    from mlapi_tpu_torch.ops import cuda as kern

    if not kern.__file__.startswith(str(Path(tree).resolve())):
        raise SystemExit(f"imported {kern.__file__}, not the tree {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs = _smoke()
    if task == "build":
        from mlapi_tpu_torch.ops.cuda import build

        spills = {}
        for name, built in build.build().items():
            for kernel, ptx in cs.ptxas_summary(built.log).items():
                if ptx.get("spill_store_bytes") or ptx.get("spill_load_bytes"):
                    spills[f"{name} {kernel}"] = ptx
        print(json.dumps({"case": "build", "tree": label,
                          "spilling_kernels": spills}), flush=True)
    elif task == "bits":
        _same_bits(cs, kern, torch, arg)
    elif task == "kernels":
        _kernels(cs, kern, label)
    elif task == "checkpoints":
        _checkpoints(cs, arg)
    elif task == "decode":
        _decode(cs, label, arg)
    else:
        _train(cs, label, int(arg))


def _run(tree, label, task, arg="", background=False):
    cmd = [sys.executable, str(Path(__file__).resolve()), "--worker", tree,
           label, task, arg]
    if background:
        return subprocess.Popen(cmd, cwd=tree)
    rc = subprocess.run(cmd, cwd=tree).returncode
    if rc:
        raise SystemExit(f"{task} in the {label} tree exited {rc}")
    return None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout of the parent commit")
    ap.add_argument("--steps", type=int, default=15,
                    help="timed training steps per run")
    ap.add_argument("--sections", default="bits,kernels,train,decode",
                    help="comma-separated: bits, kernels, train, decode")
    ap.add_argument("--worker", nargs=4, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(*args.worker)
        return 0
    if not args.parent:
        ap.error("--parent is required")
    sections = set(args.sections.split(","))
    if not sections <= {"bits", "kernels", "train", "decode"}:
        ap.error(f"unknown --sections {args.sections!r}")
    trees = {"parent": str(Path(args.parent).resolve()), "change": str(ROOT)}
    builds = [_run(t, n, "build", background=True) for n, t in trees.items()]
    if any(p.wait() for p in builds):
        raise SystemExit("a tree's kernels did not build")
    failed = False
    if "bits" in sections:
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            for label, tree in trees.items():
                _run(tree, label, "bits", f"{tmp}/{label}.pt")
            import torch

            a, b = (torch.load(f"{tmp}/{n}.pt") for n in trees)
        differ = sorted(k for k in a if not torch.equal(a[k], b[k]))
        print(json.dumps({"case": "same_bits", "outputs": len(a),
                          "differ": differ}), flush=True)
        failed = bool(differ) or a.keys() != b.keys()
    if "kernels" in sections:
        for label in ORDER:
            _run(trees[label], label, "kernels")
    if "train" in sections:
        for label in ORDER:
            _run(trees[label], label, "train", str(args.steps))
    if "decode" in sections:
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            _run(trees["change"], "change", "checkpoints", tmp)
            for label in ORDER:
                _run(trees[label], label, "decode", tmp)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
