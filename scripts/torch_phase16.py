#!/usr/bin/env python3
"""chip_smoke's phase 16 alone on one GPU: gang serving.

Run from the root of the repository on a machine with the card::

    python3 scripts/torch_phase16.py

It builds every kernel source, serves phase 4's 16 requests on
Llama-3-8B in this process through the bf16 engine and the quantized one
(phases 4 and 4b, whose tokens 16a and 16c stand beside), frees the
weights, then runs ``chip_smoke.gang_phase``: 16a two decode hosts under
the port's AM behind the port's frontend, 16b decode:0 killed mid-stream
in the same job, 16c one prefill and one decode host, quantized, handing
every prompt's blocks over. It prints what chip_smoke prints for phase
16, beside the card's name and power limit. Imports nothing of JAX.
"""

from __future__ import annotations

import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_phase16: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    cs.disarm_spine()
    torch.backends.cuda.matmul.allow_tf32 = False
    from tony_tpu_torch.ops._build import load

    card = cs.card_line()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(cs.KERNEL_SOURCES)) as pool:
        list(pool.map(load, cs.KERNEL_SOURCES))
    cs.log(f"build {time.perf_counter() - t0:.1f} s  [{card}]")
    cfg, params = cs.llama_params()
    s = cs.serve_phase(cfg, params)
    qs = cs.quant_serve_phase(cfg, params, s, breakdown=False)
    cs.log(f"phases 4 and 4b: {s['decode_steps']} and {qs['decode_steps']} decode steps, "
           f"mean TTFT {s['mean_ttft_s'] * 1e3:.1f} and {qs['mean_ttft_s'] * 1e3:.1f} ms; "
           f"the prefill paths (fault F6) {s['prefix_path']}  [{card}]")
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cs.gang_phase(card, s, qs)
    cs.log(f"phase 16 wall {time.perf_counter() - t0:.1f} s  [{card}]")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
