#!/usr/bin/env python3
"""Time the port's bf16 kernels built from two kernel-source trees on one
card, in turns.

    python3 scripts/torch_kernel_ab.py OTHER_CSRC [--cases gmm|flash|moe|decode|quant|ce|qmm|path] [--rounds 2] [--armed]

OTHER_CSRC is the ``tony_tpu_torch/csrc`` of another checkout (a parent
commit unpacked with ``git archive`` into a git-ignored directory). Each
measurement runs in a process of its own, with the kernels built from one
tree (``ops/_build.py``, into that tree's ``build/``), in the order other,
this, this, other, ...: two versions are compared only inside one run on
one card. Each process prints one JSON line: its tree, the tensor-core
instances' registers and spills, and each bf16 case of
``chip_smoke.gmm_cases`` or ``chip_smoke.flash_cases`` at the main path's
shapes (kernel ms, max |err|, whether it held its plain version, the
library call's ms, and for gmm the instance and the library call's note);
``--cases moe`` instead times bench_moe's training step end to end:
``fit()`` for 10 steps as chip_smoke's phase 6 runs it (p50 and p99 step
on the host clock, tokens/s, the losses). ``--cases decode`` times the
bf16 decode kernels: ``chip_smoke.decode_case`` at G 1, 5 and the verify
step's 16, ``chip_smoke.contiguous_case`` at the reference bench's case
and Llama-3-8B's G 1, and the bench's 24-call loop. ``--cases quant``
times the quantized decode kernel with bf16 queries:
``chip_smoke.quant_decode_case`` over int8 and fp8 e4m3 pools at G 1, 5
and the verify step's 16, each with kernel 8's time over the same pools
dequantized beforehand (``kernel8_ms``). ``--cases ce`` times the bf16 CE
kernels at bench_1b4's head (``chip_smoke.ce_cases``): the forward beside
``_scan_fwd``, the dh half (``ce_bwd(..., dw=False)``) and the dW pass
over every chunk, each held against its plain version (the backward
launched twice bit-equal), with the whole ``_scan_bwd`` beside them
(``library_ms``) and the whole kernel backward (``whole_bwd_ms``); a
library without ``ce_route`` runs the mma.sync instances. ``--cases qmm``
times the bf16 int8 dequant-matmul (``chip_smoke.quant_mm_case``) at the
decode step's five weight shapes and 8, 16 and 128 rows, each held
against its plain version with its rows bit-equal to calls of 8 rows and
of one, and each M's cases summed per step (``chip_smoke.quant_mm_step``),
beside the time the same timing gives a launch of a 16-element add
(``launch_floor_ms``);
a package without ``kernel_instance`` there has the scalar body only.
``--cases path`` times the main path of each whole tree, through that
tree's own ``chip_smoke.py``: phase 4 (the bf16 engine's 16 requests on
Llama-3-8B: mean decode step, the profiled step's wall and device ms,
TTFT, tokens/s) and phase 6 (bench_moe's 10 ``fit()`` steps: mean and p50
step, the profiled step's wall and device ms), with the observability
spine disarmed as chip_smoke disarms it; ``--armed`` adds a third run of
this checkout with the spine at its defaults (no ``TONY_*`` variable
set), in the order other, this, this armed, then the reverse. The
decode and quant_mm entry points grew workspace arguments, and a CE tree
may differ in the wrapper's chunk width, so for decode, quant, ce, qmm
and path the other side imports the whole ``tony_tpu_torch`` package of
the other checkout (``OTHER_CSRC``'s parent's parent), not its csrc/
alone; a decode package without ``kernel_instance`` has the scalar CTA
body only. Exits non-zero without
a card, when a process fails or when a case does not hold its plain
version.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def measure(csrc: str, cases: str, armed: bool = False) -> dict:
    """This process's measurement, the kernels built from ``csrc`` ("" for
    this checkout's)."""
    whole_tree = cases in ("decode", "quant", "ce", "qmm", "path") and csrc
    root = Path(csrc).resolve().parent.parent if whole_tree else ROOT
    sys.path.insert(0, str(root))
    import torch

    from tony_tpu_torch.ops import _build

    if csrc and not whole_tree:
        _build.CSRC = Path(csrc).resolve()
        _build.BUILD_DIR = _build.CSRC / "build"
    # this checkout's cases, whichever package is on the path; the path's
    # phases are each tree's own
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", (root if cases == "path" else ROOT) / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)

    torch.backends.cuda.matmul.allow_tf32 = False
    source = {"gmm": "grouped_mm", "flash": "flash_attention", "moe": "grouped_mm",
              "path": "grouped_mm",
              "decode": "paged_decode_attention", "quant": "paged_decode_attention",
              "ce": "fused_ce", "qmm": "quant_mm"}[cases]
    out = {"csrc": csrc or "this checkout", "card": chip_smoke.card_line(),
           "resources": chip_smoke.tensor_core_resources(_build.load(source).log)}
    if cases == "path":
        out.update(armed=armed, **path_case(chip_smoke, armed), cases=[])
        return out
    if cases == "moe":
        from tony_tpu_torch.train import DataConfig, FitConfig, fit

        cfg = chip_smoke.moe_train_config()
        steps: list[dict] = []
        final = fit(FitConfig(model=cfg, data=DataConfig(global_batch=8, seq_len=2048,
                                                         vocab_size=cfg.vocab_size),
                              steps=chip_smoke.MOE_TRAIN_STEPS, log_every=1, lr=3e-4,
                              warmup_steps=2, mu_dtype="bfloat16", on_metrics=steps.append),
                    device="cuda")
        out["moe"] = {"p50_ms": final["step_time_p50_s"] * 1e3,
                      "p99_ms": final["step_time_p99_s"] * 1e3,
                      "tokens_per_s": final["tokens_per_sec_per_chip"],
                      "losses": [m["loss"] for m in steps]}
        out["cases"] = []
        return out
    flush = torch.empty(chip_smoke.FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    if cases in ("decode", "quant"):
        out["cases"] = (decode_cases if cases == "decode" else quant_cases)(chip_smoke, flush)
        return out
    if cases == "ce":
        out["cases"] = ce_cases(chip_smoke, flush, _build.load(source).lib)
        return out
    if cases == "qmm":
        out["cases"], out["steps"] = qmm_cases(chip_smoke, flush)
        # what the same timing gives a launch that does next to nothing
        tiny = torch.zeros(16, device="cuda")
        out["launch_floor_ms"] = chip_smoke.time_ms(lambda: tiny.add_(1), flush)
        return out
    if cases == "gmm":
        found = chip_smoke.gmm_cases(torch.bfloat16, flush, chip_smoke.gmm_inputs())
        key = ("name", "direction")
    else:
        found = [c for shape in chip_smoke.FLASH_SHAPES
                 for c in chip_smoke.flash_cases(torch.bfloat16, flush, *shape)]
        key = ("name", "shape")
    out["cases"] = [{**{k: c[k] for k in key},
                     **{k: c[k] for k in ("ms", "max_abs_err", "ok", "library_ms")},
                     **{k: c[k] for k in ("instance", "library_note") if k in c}}
                    for c in found]
    return out


def path_case(chip_smoke, armed: bool) -> dict:
    """Phases 4 and 6 of the tree's ``chip_smoke``: the spine disarmed as
    its ``main`` disarms it (a tree without one has none), or ``armed`` at
    its defaults."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from tony_tpu_torch.ops._build import load

    if not armed and hasattr(chip_smoke, "disarm_spine"):
        chip_smoke.disarm_spine()
    with ThreadPoolExecutor(len(chip_smoke.KERNEL_SOURCES)) as pool:
        list(pool.map(load, chip_smoke.KERNEL_SOURCES))
    cfg, params = chip_smoke.llama_params()
    s = chip_smoke.serve_phase(cfg, params)
    del params
    torch.cuda.empty_cache()
    m = chip_smoke.train_moe_phase(chip_smoke.card_line())
    return {"serve": {k: s[k] for k in ("mean_decode_step_ms", "profile_step_ms",
                                        "profile_device_ms", "mean_ttft_s",
                                        "decode_tokens_per_s")},
            "moe": {"mean_step_ms": m["mean_step_ms"],
                    "p50_ms": m["final"]["step_time_p50_s"] * 1e3,
                    "profile_step_ms": m["profile_step_ms"],
                    "profile_device_ms": m["profile_device_ms"]}}


def _instances_named() -> None:
    """A package without ``kernel_instance`` runs the scalar CTA body only
    (the package exports a function of the module's name: import by
    name)."""
    module = importlib.import_module("tony_tpu_torch.ops.decode_attention")
    if not hasattr(module, "kernel_instance"):
        module.kernel_instance = lambda *args: "scalar"


_KEYS = ("name", "case", "instance", "ms", "max_abs_err", "library_ms")


def quant_cases(chip_smoke, flush) -> list[dict]:
    """Phase 3d's bf16 cases of the quantized decode kernel (each raises
    unless it holds its plain version)."""
    import torch

    _instances_named()
    found = []
    for kv in ("int8", "fp8_e4m3"):
        for G, past in ((1, ()), (5, ()),
                        (chip_smoke.SPEC_DRAFT + 1, chip_smoke.QUANT_VERIFY_PAST)):
            c = chip_smoke.quant_decode_case(kv, G, torch.bfloat16, flush, past=past)
            found.append({"name": "paged_decode_attention_quant", "case": f"{kv} G {G}",
                          **c})
    return [{k: c[k] for k in _KEYS + ("kernel8_ms",)} | {"ok": True} for c in found]


def decode_cases(chip_smoke, flush) -> list[dict]:
    """The bf16 decode cases (each raises unless it holds its plain
    version) and the bench loop."""
    import numpy as np
    import torch

    _instances_named()
    found = []
    for G, past in ((1, ()), (5, ()), (chip_smoke.SPEC_DRAFT + 1, chip_smoke.VERIFY_PAST)):
        c = chip_smoke.decode_case(G, torch.bfloat16, flush, past=past)
        found.append({"name": "paged_decode_attention", "case": f"G {G}", **c})
    bk = chip_smoke.BENCH_KERN
    for label, B, H, Hkv, T, lens, block in (
            ("bench", bk["B"], bk["H"], bk["Hkv"], bk["T"], np.full(bk["B"], bk["T"]),
             bk["block"]),
            ("llama3_8b G 1", 8, 32, 8, 2048, np.full(8, 2048), 128)):
        c = chip_smoke.contiguous_case(label, B, H, Hkv, bk["hd"], T, 1,
                                       lens.astype(np.int32), torch.bfloat16, flush, block)
        found.append({"name": "decode_attention", "case": label, **c})
    loop = chip_smoke.contiguous_bench_loop(flush)
    found.append({"name": "decode_attention", "case": "bench loop (24 calls)",
                  "instance": found[-1]["instance"], "library_ms": None, **loop})
    return [{k: c[k] for k in _KEYS} | {"ok": True} for c in found]


def qmm_cases(chip_smoke, flush) -> tuple[list[dict], dict]:
    """Phase 3d's bf16 dequant-matmul cases at 8, 16 and 128 rows (``ok``
    false unless each holds its plain version with its rows bit-equal to
    calls of 8 rows and of one), and each M's step sums."""
    import torch

    module = importlib.import_module("tony_tpu_torch.ops.quant_mm")
    if not hasattr(module, "kernel_instance"):
        module.kernel_instance = lambda dtype: "scalar"
    found = [chip_smoke.quant_mm_case(label, D, N, torch.bfloat16, flush, M)
             for M in (8, 16, 128) for label, D, N, _ in chip_smoke.QUANT_MM_SHAPES]
    keys = ("label", "M", "instance", "ms", "bound_ms", "max_abs_err", "ok", "rows_equal",
            "library_ms")
    steps = {M: {k: v for k, v in chip_smoke.quant_mm_step(found, M).items()
                 if k in ("ms", "bound_ms", "library_ms", "launches")} for M in (8, 16, 128)}
    return [{k: c[k] for k in keys} for c in found], steps


def ce_cases(chip_smoke, flush, lib) -> list[dict]:
    """Phase 3e's bf16 cases at bench_1b4's head (``ok`` false unless each
    holds its plain version and two backward launches are bit-equal)."""
    import torch

    from tony_tpu_torch.ops import fused_ce

    if not hasattr(lib, "ce_route"):
        fused_ce.kernel_instance = (
            lambda name, dtype: "mma.sync" if dtype == torch.bfloat16 else "scalar")
    keys = ("name", "instance", "ms", "max_abs_err", "ok", "bit_equal", "library_ms",
            "whole_bwd_ms")
    return [{k: c[k] for k in keys} for c in chip_smoke.ce_cases(torch.bfloat16, flush)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", nargs="?", default="", help="the other tree's csrc/")
    ap.add_argument("--cases", default="gmm",
                    choices=("gmm", "flash", "moe", "decode", "quant", "ce", "qmm", "path"))
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--armed", action="store_true",
                    help="path: also this checkout with the spine at its defaults")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if args.worker is not None:
        out = measure(args.worker, args.cases, args.armed)
        print(json.dumps(out), flush=True)
        return 0 if all(c["ok"] for c in out["cases"]) else 1
    if not args.other:
        ap.error("give the other tree's csrc/")
    rc = 0
    runs = [(args.other, False), ("", False)]
    if args.armed:
        runs.append(("", True))
    for r in range(args.rounds):
        for csrc, armed in (runs if r % 2 == 0 else runs[::-1]):
            proc = subprocess.run([sys.executable, __file__, "--worker", csrc,
                                   "--cases", args.cases] + ["--armed"] * armed, cwd=ROOT)
            rc = rc or proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
