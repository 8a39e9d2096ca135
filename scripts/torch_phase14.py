#!/usr/bin/env python3
"""chip_smoke's phase 14 alone on one GPU, and one profile window's anatomy.

Run from the root of the repository on a machine with the card::

    python3 scripts/torch_phase14.py

It builds the flash and CE kernels, runs phase 14's one-process twin
(``chip_smoke.elastic_twin``), starts two rank processes of this script
(``--rank``) that bring up gloo over tcp://localhost on the one card and
call ``chip_smoke.elastic_runs`` (elastic ``fit()`` on a 2-layer
bench_1b4, 2 members of 1 rank, plan ``{2: (0,), 4: (0, 1)}``), and holds
them as phase 14 does (``chip_smoke.elastic_phase``). Then a 3-step
``fit()`` of the same model with a profile window on step 2: its pushes'
memory keys (``chip_smoke.check_memory_keys``) and the window's anatomy
budget (``chip_smoke.window_anatomy``). Fresh rank processes pay their
warm-up in step 1, which chip_smoke's shared ones paid in phase 7.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def rank_main(rank: int, port: int, out: str, work_dir: str) -> None:
    import torch.distributed as dist

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=2)
    res = {"14": cs.elastic_runs(rank, work_dir)}
    dist.barrier()
    dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(res, f)


def main() -> int:
    from tony_tpu_torch.obs import profile
    from tony_tpu_torch.ops._build import load
    from tony_tpu_torch.train import FitConfig, fit

    if not torch.cuda.is_available():
        print("torch_phase14: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    cs.disarm_spine()
    card = cs.card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(load, ["flash_attention", "fused_ce"]))
    cs.log(f"build {time.perf_counter() - t0:.1f} s")
    twin = cs.elastic_twin()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    tmp = tempfile.mkdtemp(prefix="phase14-")
    outs = [f"{tmp}/rank{r}.json" for r in range(2)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r), str(port), outs[r],
                               f"{tmp}/elastic"]) for r in range(2)]
    try:
        codes = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(codes):
        raise AssertionError(f"rank processes exited {codes}")
    shared = [json.load(open(path)) for path in outs]
    cs.log(f"rank processes {time.perf_counter() - t0:.1f} s")
    el = cs.elastic_phase(card, twin, shared)
    print("boundaries", json.dumps(el["bounds"]))
    print("generation broadcast ms", el["agree_ms"], "step ms", el["step_ms"],
          "wall s", el["wall_s"])
    print("summary", el["ranks"][0]["final"]["elastic"], el["skips"])

    app = tempfile.mkdtemp(prefix="phase14-app-")
    cs._spine_env(app, armed=False)
    steps: list[dict] = []

    def on_metrics(m: dict) -> None:
        steps.append(m)
        if m["step"] == 1:
            profile.active_controller().trigger(steps=1)

    fit(FitConfig(model=cs.elastic_config(), data=cs.elastic_data(), steps=3, log_every=1,
                  warmup_steps=2, mu_dtype="bfloat16", on_metrics=on_metrics), device="cuda")
    cs.check_memory_keys("probe", steps)
    print("first push", {k: steps[0][k] for k in sorted(steps[0])})
    anatomy = cs.window_anatomy(app)
    print("anatomy", json.dumps(anatomy["table"]), "device trace", anatomy["device_trace"])
    print(card)
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
        sys.exit(0)
    sys.exit(main())
