#!/usr/bin/env python3
"""Time the port's bf16 kernels built from two kernel-source trees on one
card, in turns.

    python3 scripts/torch_kernel_ab.py OTHER_CSRC [--cases gmm|flash|moe] [--rounds 2]

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
on the host clock, tokens/s, the losses). Exits non-zero without a card,
when a process fails or when a case does not hold its plain version.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def measure(csrc: str, cases: str) -> dict:
    """This process's measurement, the kernels built from ``csrc`` ("" for
    this checkout's)."""
    sys.path.insert(0, str(ROOT))
    import torch

    from tony_tpu_torch.ops import _build

    if csrc:
        _build.CSRC = Path(csrc).resolve()
        _build.BUILD_DIR = _build.CSRC / "build"
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    source = {"gmm": "grouped_mm", "flash": "flash_attention", "moe": "grouped_mm"}[cases]
    out = {"csrc": csrc or "this checkout", "card": chip_smoke.card_line(),
           "resources": chip_smoke.tensor_core_resources(_build.load(source).log)}
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
    flush = torch.empty(256 * 2**20 // 4, dtype=torch.float32, device="cuda")
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", nargs="?", default="", help="the other tree's csrc/")
    ap.add_argument("--cases", choices=("gmm", "flash", "moe"), default="gmm")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if args.worker is not None:
        out = measure(args.worker, args.cases)
        print(json.dumps(out), flush=True)
        return 0 if all(c["ok"] for c in out["cases"]) else 1
    if not args.other:
        ap.error("give the other tree's csrc/")
    rc = 0
    for r in range(args.rounds):
        order = (args.other, "") if r % 2 == 0 else ("", args.other)
        for csrc in order:
            proc = subprocess.run([sys.executable, __file__, "--worker", csrc,
                                   "--cases", args.cases], cwd=ROOT)
            rc = rc or proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
