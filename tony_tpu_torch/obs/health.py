"""Numerics health sentinel: device-side value monitors, anomaly rules,
and bad-step forensics. The port's counterpart of
``tony_tpu/obs/health.py``.

Three layers, as in the reference:

- **Device-side monitors** (:func:`graph_monitors`, :func:`decode_monitors`)
  are reductions on the step's own tensors: summed nonfinite counts over
  grads/params/loss, the update-to-param ratio, per-layer grad RMS over
  the stacked layer dim, a positional batch fingerprint, and, serve side,
  per-slot logits-nonfinite counts and sampling entropy. The train step
  updates parameters in place, so it does not hand :func:`graph_monitors`
  an update tree: it accumulates ``|Δθ|²`` inside the optimizer's chunk
  loop and takes the parameters' norm and nonfinite count after the
  update, then assembles the same keys with :func:`monitors_from_sums`.
  The steps build them only where :func:`due` says the armed sentinel
  reads that step (one in ``sample_every``): the reference's jitted step
  computes them on every step, but an eager step need not pay for values
  nobody reads, and the sampled steps' values are the same. When no
  sentinel is armed none of it is computed.
- **The hot-path seam** (:func:`sample`): disarmed it is ONE global load +
  ``None`` compare; armed off-stride it is one counter bump. A stride hit
  records an event behind the step's work and enqueues the step's
  tensors (fresh each step, so nothing overwrites them); the sentinel's
  worker thread waits on the event on a stream of its own and copies
  them into pinned host memory with ``non_blocking=True``. The step loop
  issues no copy and no sync for it.
- **The rule engine** (:class:`HealthSentinel`): the reference's host-side
  rules, forensics bundles, verdict file and read paths, copied.
"""

from __future__ import annotations

import json
import logging
import math
import os
import queue
import threading
import time
from collections import deque
from dataclasses import asdict, dataclass
from typing import Any

log = logging.getLogger(__name__)

# env contract (AM -> executor -> user process, next to TONY_TRACE_* and
# TONY_OBS_HBM*)
ENV_ENABLED = "TONY_OBS_HEALTH"          # "0" disables arming
ENV_SAMPLE = "TONY_OBS_HEALTH_SAMPLE"    # rule-evaluation stride (steps)
ENV_WINDOW = "TONY_OBS_HEALTH_WINDOW"    # rolling-stats window + ring size

# numerics chaos seam (tests / chaos jobs): fit()'s train step adds an
# in-graph NaN to the reported loss from this step onward (persistent,
# like a real NaN'd state), so a tier-1 job can prove injection -> trip
# -> forensics end to end
ENV_NAN_STEP = "TONY_CHAOS_NAN_STEP"

# every rule the engine can trip (docs/OBS.md "Numerics health")
RULES = (
    "nonfinite",        # NaN/Inf in loss, grads, or params
    "loss_spike",       # loss z-score over the rolling window
    "grad_explosion",   # global grad norm above the absolute ceiling
    "grad_collapse",    # global grad norm ~0 for k consecutive samples
    "stagnation",       # loss flat to within rel tolerance over the window
    "repeated_batch",   # identical batch fingerprint k times in a row
    "serve_nonfinite",  # NaN/Inf logits in a live decode slot
    "entropy_floor",    # sampling entropy under the floor for k steps
)


# --- device-side monitors ------------------------------------------------------


def _float_tensors(tree) -> list:
    """The floating-point tensors of a nested dict or a sequence."""
    import torch

    if isinstance(tree, dict):
        tree = list(tree.values())
    out = []
    for x in tree:
        if isinstance(x, (dict, list, tuple)):
            out.extend(_float_tensors(x))
        elif isinstance(x, torch.Tensor) and x.is_floating_point():
            out.append(x)
    return out


def nonfinite_count(tree, device=None):
    """Count of NaN/Inf elements over every float tensor of ``tree``, as a
    float32 0-d tensor (the reference's type: counts only gate on > 0).
    Each tensor's finite elements are counted in int64, so the count is
    exact whatever the tensor's size."""
    import torch

    tensors = _float_tensors(tree)
    total = torch.zeros((), dtype=torch.int64,
                        device=device if device is not None else tensors[0].device)
    for t in tensors:
        total = total + (t.numel() - torch.isfinite(t).sum())
    return total.to(torch.float32)


def sq_norm(tree, device=None):
    """Sum of float32 squares over every float tensor of ``tree``, one read
    of each (``vector_norm`` accumulates in float32 without a float32 copy
    of a bf16 tensor); outside autograd, as a parameter tree's norm is a
    reading, not part of the loss."""
    import torch

    tensors = _float_tensors(tree)
    total = torch.zeros((), dtype=torch.float32,
                        device=device if device is not None else tensors[0].device)
    with torch.no_grad():
        for t in tensors:
            total = total + torch.linalg.vector_norm(t, dtype=torch.float32).square()
    return total


def monitors_from_sums(loss, nonfinite_grads, nonfinite_params, param_sq, update_sq,
                       fingerprint, layer_rms=None) -> dict:
    """The train step's ``health/...`` metrics from their parts (each a
    fresh float32 device tensor; ``fingerprint`` int64): what
    :func:`graph_monitors` returns, for a step that sums the parts itself
    (in place, or across a mesh)."""
    import torch

    out = {
        "health/nonfinite_loss": (~torch.isfinite(loss)).to(torch.float32),
        "health/nonfinite_grads": nonfinite_grads,
        "health/nonfinite_params": nonfinite_params,
        # update-to-param ratio |Δθ|/|θ|: the classic silent-divergence
        # telltale (a healthy Adam run sits around lr-scale; 0 means a
        # dead optimizer, >>lr means a blowup in progress)
        "health/update_ratio": torch.sqrt(update_sq) / (torch.sqrt(param_sq) + 1e-12),
        "health/batch_fingerprint": fingerprint,
    }
    if layer_rms is not None:
        out["health/layer_grad_rms"] = layer_rms
    return out


def graph_monitors(loss, grads, params, updates, inputs) -> dict:
    """The reference's value monitors over trees: ``grads``, the updated
    ``params`` and the ``updates`` applied (nested dicts of tensors, or
    sequences), and the token batch. Keys are namespaced ``health/...`` so
    the host-side engine can split them from the ordinary metrics."""
    return monitors_from_sums(
        loss, nonfinite_count(grads, loss.device), nonfinite_count(params, loss.device),
        sq_norm(params, loss.device), sq_norm(updates, loss.device),
        batch_fingerprint(inputs), layer_grad_rms(grads))


def _layer_leaves(layers: dict) -> list:
    """The stacked ``[L, ...]`` float leaves of a ``layers`` dict that share
    the first leaf's layer count (the reference's selection)."""
    leaves = [t for t in _float_tensors(layers) if t.ndim >= 1]
    if not leaves:
        return []
    n_layers = leaves[0].shape[0]
    return [t for t in leaves if t.shape[0] == n_layers]


def layer_sq(leaf):
    """float32 sums of squares of a stacked ``[L, ...]`` leaf, one per layer."""
    import torch

    if leaf.ndim == 1:
        return leaf.float().square()
    return torch.linalg.vector_norm(leaf, dim=tuple(range(1, leaf.ndim)),
                                    dtype=torch.float32).square()


def layer_sq_sums(layers: dict):
    """(per-layer float32 sums of squares ``[L]``, elements per layer) over
    the stacked leaves of ``layers``; (None, 0) when there are none."""
    import torch

    leaves = _layer_leaves(layers)
    if not leaves:
        return None, 0
    sq = torch.zeros((leaves[0].shape[0],), dtype=torch.float32, device=leaves[0].device)
    count = 0
    for leaf in leaves:
        sq = sq + layer_sq(leaf)
        count += int(math.prod(leaf.shape[1:]) or 1)
    return sq, count


def layer_grad_rms(grads):
    """Per-layer grad RMS over the stacked layer dim (``[L]``), the
    which-layer-went-bad attribution a forensics bundle carries. None when
    the tree has no ``layers`` stack."""
    import torch

    layers = grads.get("layers") if isinstance(grads, dict) else None
    if not layers:
        return None
    sq, count = layer_sq_sums(layers)
    if sq is None:
        return None
    return torch.sqrt(sq / float(max(count, 1)))


_U32 = 0xFFFFFFFF
_KNUTH = 2654435761


def fingerprint_sum(inputs, positions=None):
    """The batch fingerprint's sum over ``inputs`` at flat ``positions`` of
    the global batch (default: ``inputs`` is the whole batch), as an int64
    tensor in ``[0, 2**32)``. Partial sums over the blocks of one batch add
    up, modulo ``2**32``, to the whole batch's."""
    import torch

    flat = inputs.reshape(-1).long() & _U32
    if positions is None:
        positions = torch.arange(flat.numel(), dtype=torch.int64, device=flat.device)
    weights = (positions.reshape(-1) * _KNUTH + 1) & _U32
    return ((flat * weights) & _U32).sum() & _U32


def batch_fingerprint(inputs):
    """Position-weighted uint32 checksum of a token batch, bit-equal to the
    reference's (uint32 arithmetic that wraps, computed in int64 and masked
    to the low 32 bits). Equal batches produce equal fingerprints, permuted
    or shifted ones do not: the repeated-batch rule detects a wedged input
    pipeline feeding the same data every step."""
    return fingerprint_sum(inputs)


def decode_monitors(logits) -> dict:
    """Value monitors for the serve decode step: per-slot nonfinite counts
    over the sampling logits and the softmax entropy (nats) of the
    distribution the sampler draws from, ``[S]``-shaped so the host engine
    can attribute a trip to the request occupying the slot."""
    import torch

    finite = torch.isfinite(logits)
    safe = torch.where(finite, logits, float("-inf"))
    logp = torch.log_softmax(safe, dim=-1)
    p = torch.exp(logp)
    entropy = -torch.where(p > 0, p * logp, 0.0).sum(dim=-1)
    return {
        "logits_nonfinite": (~finite).sum(dim=-1, dtype=torch.float32),
        "entropy": entropy.to(torch.float32),
    }


def _stage(args: dict[str, Any]) -> tuple[dict[str, Any], Any]:
    """The step thread's half of a sample: where ``args`` holds CUDA
    tensors (one level of dicts deep), record an event on the current
    stream behind the step's work; no copy and no sync here. The tensors
    are fresh per step and the queue holds them until the worker has
    copied them. Returns (args, event or None)."""
    import torch

    def cuda_tensors(v):
        vals = v.values() if isinstance(v, dict) else [v]
        return any(isinstance(x, torch.Tensor) and x.is_cuda for x in vals)

    event = None
    if any(cuda_tensors(v) for v in args.values()):
        event = torch.cuda.Event()
        event.record()
    return args, event


def _copy_to_pinned(args: dict[str, Any], event) -> dict[str, Any]:
    """The worker's half: on a stream of its own, wait for ``event``, copy
    every CUDA tensor into a pinned host tensor with ``non_blocking=True``,
    and wait for those copies alone. The device-to-host traffic is issued
    from this thread, never the step loop's."""
    import torch

    dev = next(x.device for v in args.values()
               for x in (v.values() if isinstance(v, dict) else [v])
               if isinstance(x, torch.Tensor) and x.is_cuda)
    with torch.cuda.device(dev):
        stream = torch.cuda.Stream()
        stream.wait_event(event)
        with torch.cuda.stream(stream):

            def one(v):
                if isinstance(v, torch.Tensor) and v.is_cuda:
                    host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                    host.copy_(v.detach(), non_blocking=True)
                    return host
                return v

            out = {k: ({kk: one(vv) for kk, vv in v.items()} if isinstance(v, dict)
                       else one(v)) for k, v in args.items()}
        stream.synchronize()
    return out


def _to_host(v):
    """numpy for a tensor (0-d included), recursively through dicts."""
    import torch

    if isinstance(v, dict):
        return {k: _to_host(x) for k, x in v.items()}
    if isinstance(v, torch.Tensor):
        return v.detach().numpy()
    return v


def nan_inject_step() -> int | None:
    """The numerics chaos seam: step number from which the train step
    poisons its reported loss with an in-graph NaN (``TONY_CHAOS_NAN_STEP``,
    exported into worker env by a chaos-style job config). None = off."""
    raw = os.environ.get(ENV_NAN_STEP, "")
    if not raw:
        return None
    try:
        return int(raw)
    except ValueError:
        return None


# --- host-side rule engine ----------------------------------------------------


@dataclass(frozen=True)
class HealthRules:
    """Rule thresholds (docs/OBS.md has the semantics table)."""

    window: int = 64          # rolling-stats window AND forensics ring size
    min_samples: int = 8      # samples before z-score rules may fire
    loss_spike_z: float = 8.0
    grad_explode: float = 1e4
    grad_collapse: float = 1e-8
    collapse_k: int = 4
    stagnation_rel: float = 1e-9  # (max-min)/|mean| over a FULL window
    repeat_k: int = 3
    entropy_floor: float = 0.05   # nats; vocab-V healthy decode is O(ln V)
    entropy_k: int = 8


class HealthSentinel:
    """Asynchronous anomaly-rule engine over sampled step values.

    ``sample(**args)`` is the armed hot path: stride-counted, and a stride
    hit enqueues the kwargs (device references — no sync) for the daemon
    worker, which fetches them to host and evaluates the rules. Train
    samples carry ``metrics`` (the step's metrics dict, ``health/*`` keys
    included); serve samples carry ``metrics`` (``logits_nonfinite`` /
    ``entropy``), ``slot_rids``, and ``live_slots``.

    A tripped rule latches for the sentinel's lifetime (``reset()`` in
    tests): the first firing writes the forensics bundle + verdict file,
    emits the trace instant, and bumps the registry counter; repeats of a
    latched rule are not re-reported — a NaN'd run stays NaN'd every step
    and one bundle per cause is the signal, not thousands.
    """

    def __init__(self, rules: HealthRules | None = None, *,
                 sample_every: int = 16, registry=None,
                 app_dir: str | None = None, proc: str = "",
                 checkpoint_dir: str = "", queue_size: int = 64):
        from tony_tpu_torch.obs import trace

        self.rules = rules or HealthRules()
        self.sample_every = max(int(sample_every), 1)
        self._registry = registry
        self.app_dir = (
            app_dir if app_dir is not None
            else os.environ.get("TONY_APP_DIR", "")
        )
        self.proc = proc or trace.default_proc_name()
        self.checkpoint_dir = (
            checkpoint_dir or os.environ.get("TONY_CHECKPOINT_DIR", "")
        )
        self.dropped = 0          # queue overflow (worker slower than steps)
        self._n = 0               # seam stride counter
        self._pending = 0         # enqueued-but-unevaluated samples
        self._trips: dict[str, int] = {}       # rule -> trip count (latched)
        self._trip_detail: dict[str, dict] = {}  # rule -> first-trip detail
        self._bundles: list[str] = []
        self._ring: deque = deque(maxlen=max(self.rules.window, 8))
        self._losses: deque = deque(maxlen=max(self.rules.window, 8))
        self._last_step: int | None = None
        self._last_layers: list[float] | None = None
        self._collapse_run = 0
        self._repeat_run = 0
        self._last_fingerprint: float | None = None
        self._serve_step = 0
        self._entropy_runs: dict[int, int] = {}  # rid -> consecutive low
        self._lock = threading.Lock()
        self._q: queue.Queue = queue.Queue(maxsize=max(int(queue_size), 4))
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._worker, daemon=True, name="tony-health"
        )
        self._thread.start()

    # --- hot path -------------------------------------------------------------

    def sample(self, **args: Any) -> None:
        """Stride-counted enqueue; the off-stride cost is one increment +
        modulo, a stride hit is one bounded queue put of references."""
        self._n += 1
        if self._n % self.sample_every:
            return
        self.observe_async(args)

    def due(self) -> bool:
        """Whether the next :meth:`sample` hits the stride, i.e. whether
        the step about to run is one whose values are read."""
        return (self._n + 1) % self.sample_every == 0

    def observe_async(self, args: dict[str, Any]) -> None:
        try:
            with self._lock:
                self._pending += 1
            self._q.put_nowait(_stage(args))
        except queue.Full:
            with self._lock:
                self._pending -= 1
                self.dropped += 1

    # --- worker ---------------------------------------------------------------

    def _worker(self) -> None:
        while True:
            try:
                args = self._q.get(timeout=0.25)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            if args is None:  # close() sentinel
                return
            try:
                self._evaluate(self._fetch(args))
            except Exception:
                log.debug("health sample evaluation failed", exc_info=True)
            finally:
                with self._lock:
                    self._pending -= 1

    @staticmethod
    def _fetch(item) -> dict[str, Any]:
        """Device -> host for a staged sample: behind its event, the CUDA
        tensors are copied into pinned host memory on this worker's own
        stream, then read as numpy. The copies and the wait land on this
        thread, never the step loop."""
        args, event = item
        if event is not None:
            args = _copy_to_pinned(args, event)
        return _to_host(args)

    # --- rule evaluation ------------------------------------------------------

    def _evaluate(self, args: dict[str, Any]) -> None:
        metrics = args.get("metrics") or {}
        if "logits_nonfinite" in metrics or "entropy" in metrics:
            self._eval_serve(args, metrics)
        else:
            self._eval_train(metrics)

    @staticmethod
    def _scalar(v, default: float = 0.0) -> float:
        try:
            return float(v)
        except (TypeError, ValueError):
            return default

    def _eval_train(self, metrics: dict[str, Any]) -> None:
        r = self.rules
        step = int(self._scalar(metrics.get("step"), 0))
        # absence is not NaN: a caller sampling only a subset of metrics
        # (custom step loop) must never trip the nonfinite rule on keys it
        # simply did not report
        loss_raw = metrics.get("loss")
        gnorm_raw = metrics.get("grad_norm")
        loss = self._scalar(loss_raw, math.nan)
        gnorm = self._scalar(gnorm_raw, math.nan)
        health = {
            k.split("/", 1)[1]: v for k, v in metrics.items()
            if isinstance(k, str) and k.startswith("health/")
        }
        if self._last_step is not None and step <= self._last_step:
            # a new run re-entered this process (bench sweeps, tests):
            # rolling statistics must not blend two runs' trajectories
            self._reset_windows()
        self._last_step = step

        layers = health.get("layer_grad_rms")
        if layers is not None:
            try:
                self._last_layers = [round(float(x), 6) for x in layers]
            except TypeError:
                pass
        rec = {
            "step": step,
            "loss": None if math.isnan(loss) else round(loss, 6),
            "grad_norm": None if math.isnan(gnorm) else round(gnorm, 6),
        }
        for key in ("nonfinite_loss", "nonfinite_grads", "nonfinite_params",
                    "update_ratio", "batch_fingerprint"):
            if key in health:
                rec[key] = self._scalar(health[key])
        self._ring.append(rec)

        # nonfinite: the unambiguous trip — any NaN/Inf in loss/grads/params
        bad = {
            k: self._scalar(health.get(k))
            for k in ("nonfinite_loss", "nonfinite_grads", "nonfinite_params")
            if self._scalar(health.get(k)) > 0
        }
        if not health and loss_raw is not None and not math.isfinite(loss):
            bad["loss"] = loss  # monitor-less sample: the loss itself tells
        if (loss_raw is not None and math.isnan(loss)) or (
            gnorm_raw is not None and math.isnan(gnorm)
        ):
            bad.setdefault("nonfinite_loss", 1.0)
        if bad:
            self._trip("nonfinite", step, {"counts": bad})

        # loss spike: z-score against the rolling window of FINITE losses
        if math.isfinite(loss):
            if len(self._losses) >= r.min_samples:
                mean = sum(self._losses) / len(self._losses)
                var = sum((x - mean) ** 2 for x in self._losses) / len(self._losses)
                std = math.sqrt(var)
                if std > 0 and (loss - mean) / std > r.loss_spike_z:
                    self._trip("loss_spike", step, {
                        "loss": loss, "window_mean": round(mean, 6),
                        "window_std": round(std, 6),
                        "z": round((loss - mean) / std, 2),
                    })
                # stagnation: a FULL window flat to relative tolerance —
                # the loop is running but learning nothing (dead optimizer,
                # zero lr, detached graph)
                if (
                    len(self._losses) == self._losses.maxlen
                    and max(self._losses) - min(self._losses)
                    <= r.stagnation_rel * max(abs(mean), 1e-12)
                    and abs(loss - mean) <= r.stagnation_rel * max(abs(mean), 1e-12)
                ):
                    self._trip("stagnation", step, {
                        "loss": loss, "window": len(self._losses),
                        "spread": max(self._losses) - min(self._losses),
                    })
            self._losses.append(loss)

        # grad explosion / collapse
        if math.isfinite(gnorm):
            if gnorm > r.grad_explode:
                self._trip("grad_explosion", step, {
                    "grad_norm": gnorm, "ceiling": r.grad_explode,
                })
            if gnorm < r.grad_collapse:
                self._collapse_run += 1
                if self._collapse_run >= r.collapse_k:
                    self._trip("grad_collapse", step, {
                        "grad_norm": gnorm, "consecutive": self._collapse_run,
                    })
            else:
                self._collapse_run = 0

        # repeated batch: the data pipeline is feeding the same tokens
        fp = health.get("batch_fingerprint")
        if fp is not None:
            fp = self._scalar(fp)
            if self._last_fingerprint is not None and fp == self._last_fingerprint:
                self._repeat_run += 1
                if self._repeat_run + 1 >= r.repeat_k:
                    self._trip("repeated_batch", step, {
                        "fingerprint": int(fp),
                        "consecutive": self._repeat_run + 1,
                        "stream_step": step,
                    })
            else:
                self._repeat_run = 0
            self._last_fingerprint = fp

    def _eval_serve(self, args: dict[str, Any], metrics: dict[str, Any]) -> None:
        r = self.rules
        self._serve_step += 1
        step = self._serve_step
        slot_rids = list(args.get("slot_rids") or [])
        live = args.get("live_slots")
        nonfinite = metrics.get("logits_nonfinite")
        entropy = metrics.get("entropy")
        n_slots = len(slot_rids)
        live_idx = (
            [int(s) for s in live] if live is not None else list(range(n_slots))
        )
        rec: dict[str, Any] = {"step": step, "live": len(live_idx)}
        for s in live_idx:
            rid = slot_rids[s] if s < n_slots else None
            if nonfinite is not None and self._scalar(nonfinite[s]) > 0:
                rec["nonfinite_slot"] = s
                self._trip("serve_nonfinite", step, {
                    "rid": rid, "slot": s,
                    "nonfinite_logits": self._scalar(nonfinite[s]),
                })
            if entropy is not None:
                ent = self._scalar(entropy[s], math.inf)
                key = rid if rid is not None else -1 - s
                if ent < r.entropy_floor:
                    run = self._entropy_runs.get(key, 0) + 1
                    self._entropy_runs[key] = run
                    if run >= r.entropy_k:
                        self._trip("entropy_floor", step, {
                            "rid": rid, "slot": s,
                            "entropy": round(ent, 5),
                            "floor": r.entropy_floor,
                            "consecutive": run,
                        })
                else:
                    self._entropy_runs.pop(key, None)
        # slots freed between samples keep no stale low-entropy run
        live_keys = {
            slot_rids[s] if s < n_slots and slot_rids[s] is not None else -1 - s
            for s in live_idx
        }
        for key in list(self._entropy_runs):
            if key not in live_keys:
                del self._entropy_runs[key]
        self._ring.append(rec)

    # --- tripping -------------------------------------------------------------

    def _trip(self, rule: str, step: int, detail: dict[str, Any]) -> None:
        with self._lock:
            if rule in self._trips:
                self._trips[rule] += 1
                return
            self._trips[rule] = 1
            self._trip_detail[rule] = {"step": step, **detail}
        log.error("health rule %r tripped at step %d: %s", rule, step, detail)
        from tony_tpu_torch.obs import trace

        # the instant lands between the step spans it interrupted on the
        # merged timeline; flush immediately so a chaos SIGKILL racing the
        # flusher thread cannot outrun the marker
        trace.instant(f"health.{rule}", step=step, **{
            k: v for k, v in detail.items()
            if isinstance(v, (int, float, str, bool)) or v is None
        })
        trace.flush()
        if self._registry is not None:
            self._export_into(self._registry)
        self._dump_bundle(rule, step, detail)
        self.write_verdict()

    def _export_into(self, registry) -> None:
        with self._lock:
            trips = dict(self._trips)
        for rule, n in trips.items():
            c = registry.counter(
                "tony_health_trips_total",
                "health-rule trips (latched; counts repeats of the cause)",
                rule=rule,
            )
            c.inc(n - c.value)
        registry.gauge(
            "tony_health_verdict",
            "numerics verdict: 0 healthy, 1 tripped",
        ).set(1.0 if trips else 0.0)

    def export(self, registry) -> None:
        """Write ``tony_health_*`` into ``registry`` (fit()/engine call
        this on their per-run registry right before the shutdown snapshot,
        the hbm.export_gauges pattern, so the portal ``/metrics`` serves
        the verdict)."""
        self._export_into(registry)

    # --- forensics ------------------------------------------------------------

    def _health_dir(self) -> str:
        return os.path.join(self.app_dir, "health") if self.app_dir else ""

    def _latest_checkpoint(self) -> dict[str, Any]:
        out: dict[str, Any] = {"dir": self.checkpoint_dir}
        if self.checkpoint_dir and os.path.isdir(self.checkpoint_dir):
            steps = [
                int(d) for d in os.listdir(self.checkpoint_dir) if d.isdigit()
            ]
            if steps:
                out["latest_step"] = max(steps)
        return out

    def _dump_bundle(self, rule: str, step: int, detail: dict[str, Any]) -> None:
        """One forensics bundle per tripped rule, written synchronously at
        trip time (the marker must survive an immediate SIGKILL). Best
        effort: a full disk costs the bundle, never the run."""
        out_dir = self._health_dir()
        if not out_dir:
            return
        bundle = {
            "rule": rule,
            "step": step,
            "ts": time.time(),
            "proc": self.proc,
            "detail": detail,
            "rules": asdict(self.rules),
            "sample_every": self.sample_every,
            # the last-k step-stats ring: the trajectory INTO the bad step
            "ring": list(self._ring),
            # per-layer grad RMS at (or just before) the trip: which layer
            "layer_grad_rms": self._last_layers,
            # where the input stream was: step N is stream position N for
            # every built-in stream (synthetic keys the rng by step, mmap/
            # native seek by step), so a resume can replay the batch
            "batch": {
                "stream_step": step,
                "fingerprint": self._last_fingerprint,
                "repeats": self._repeat_run + 1 if self._repeat_run else 0,
            },
            "checkpoint": self._latest_checkpoint(),
        }
        name = f"{self.proc}_{rule}_step{step}.trip.json"
        try:
            os.makedirs(out_dir, exist_ok=True)
            path = os.path.join(out_dir, name)
            with open(path + ".tmp", "w", encoding="utf-8") as f:
                json.dump(bundle, f, default=str)
            os.replace(path + ".tmp", path)
            self._bundles.append(path)
        except OSError:
            log.warning("could not write health bundle %s", name, exc_info=True)

    def write_verdict(self) -> None:
        out_dir = self._health_dir()
        if not out_dir:
            return
        with self._lock:
            payload = {
                "verdict": "tripped" if self._trips else "healthy",
                "proc": self.proc,
                "ts": time.time(),
                "rules": {
                    rule: {"trips": n, **self._trip_detail.get(rule, {})}
                    for rule, n in self._trips.items()
                },
                "dropped_samples": self.dropped,
            }
        try:
            os.makedirs(out_dir, exist_ok=True)
            path = os.path.join(out_dir, f"verdict_{self.proc}.json")
            with open(path + ".tmp", "w", encoding="utf-8") as f:
                json.dump(payload, f, default=str)
            os.replace(path + ".tmp", path)
        except OSError:
            log.warning("could not write health verdict", exc_info=True)

    # --- lifecycle / reporting ------------------------------------------------

    @property
    def verdict(self) -> str:
        return "tripped" if self._trips else "healthy"

    def trip_counts(self) -> dict[str, int]:
        with self._lock:
            return dict(self._trips)

    def summary(self) -> dict[str, Any]:
        with self._lock:
            return {
                "verdict": "tripped" if self._trips else "healthy",
                "trips": dict(self._trips),
                "detail": dict(self._trip_detail),
                "dropped_samples": self.dropped,
            }

    def drain(self, timeout_s: float = 10.0) -> bool:
        """Wait (bounded) until every enqueued sample has been evaluated —
        fit()/engine shutdown call this so a trip on the final steps lands
        in the final report. Returns False on timeout."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if self._pending == 0:
                    return True
            time.sleep(0.005)
        return False

    def _reset_windows(self) -> None:
        # everything trajectory-shaped resets together: the forensics ring
        # and the per-layer snapshot must not blend a previous run's tail
        # into a new run's bundle any more than the z-score window may
        self._losses.clear()
        self._collapse_run = 0
        self._repeat_run = 0
        self._last_fingerprint = None
        self._entropy_runs.clear()
        self._ring.clear()
        self._last_layers = None

    def reset(self) -> None:
        """Full reset incl. trip latches (tests, explicit re-runs)."""
        self.drain(timeout_s=2.0)
        with self._lock:
            self._trips.clear()
            self._trip_detail.clear()
        self._reset_windows()
        self._ring.clear()
        self._last_step = None
        self._serve_step = 0

    def close(self, join_timeout_s: float = 2.0) -> None:
        self.drain(timeout_s=join_timeout_s)
        self._stop.set()
        try:
            self._q.put_nowait(None)
        except queue.Full:
            pass
        if self._thread is not threading.current_thread():
            self._thread.join(timeout=max(join_timeout_s, 0.0))
        self.write_verdict()


# --- process-global arming (the trace/hbm pattern) ----------------------------

_sentinel: HealthSentinel | None = None


def active_sentinel() -> HealthSentinel | None:
    return _sentinel


def install(sentinel: HealthSentinel) -> HealthSentinel:
    global _sentinel
    if _sentinel is not None and _sentinel is not sentinel:
        _sentinel.close()
    _sentinel = sentinel
    return sentinel


def uninstall() -> None:
    global _sentinel
    if _sentinel is not None:
        _sentinel.close()
        _sentinel = None


def sample(**args: Any) -> None:
    """The hot-path seam (train/serve step loops). Disarmed: one global
    load + ``None`` compare. Call sites must pass precomputed names only
    (graft-lint GL005 enforces this like the trace/chaos/hbm hooks)."""
    s = _sentinel
    if s is not None:
        s.sample(**args)


def due() -> bool:
    """Whether an armed sentinel reads the next :func:`sample`: the train
    and decode steps build their monitors only then."""
    s = _sentinel
    return s is not None and s.due()


def install_from_env() -> HealthSentinel | None:
    """Arm this process from the ``TONY_OBS_HEALTH*`` env the AM exported
    (defaults apply standalone — a bare fit() or engine gets the sentinel
    without a job). Idempotent; ``TONY_OBS_HEALTH=0`` disables."""
    if _sentinel is not None:
        return _sentinel
    if os.environ.get(ENV_ENABLED, "") == "0":
        return None

    def _env_int(key: str, default: int) -> int:
        try:
            return int(os.environ.get(key, "") or default)
        except ValueError:
            return default

    from tony_tpu_torch.obs.registry import get_registry

    window = _env_int(ENV_WINDOW, 64)
    return install(HealthSentinel(
        HealthRules(window=window),
        sample_every=_env_int(ENV_SAMPLE, 16),
        registry=get_registry(),
    ))


# --- read paths (CLI, portal, invariant checker) ------------------------------


def read_verdicts(app_dir: str) -> dict[str, dict]:
    """Per-process verdicts under ``<app_dir>/health/`` (proc -> payload).
    Deviceless read path shared by ``tony health``, the portal ``/healthz``
    endpoint, and the chaos invariant checker — ONE reader, one layout."""
    hdir = os.path.join(app_dir, "health")
    out: dict[str, dict] = {}
    try:
        names = sorted(os.listdir(hdir))
    except OSError:
        return out
    for name in names:
        if not (name.startswith("verdict_") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(hdir, name), encoding="utf-8") as f:
                payload = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        if isinstance(payload, dict):
            out[payload.get("proc") or name[len("verdict_"):-5]] = payload
    return out


def forensics_files(app_dir: str) -> list[str]:
    """Forensics bundle filenames under an app dir (the chaos runner lists
    these next to the OOM bundles)."""
    hdir = os.path.join(app_dir, "health")
    try:
        return sorted(n for n in os.listdir(hdir) if n.endswith(".trip.json"))
    except OSError:
        return []


def rollup(app_dir: str) -> dict[str, Any]:
    """The ``tony health <app_id>`` report: per-process verdicts, merged
    tripped rules, and the bundle listing. ``verdict`` is ``tripped`` when
    ANY process tripped, ``healthy`` when at least one verdict file exists
    and none tripped, ``unknown`` otherwise (job predates the sentinel, or
    it died before writing)."""
    verdicts = read_verdicts(app_dir)
    bundles = forensics_files(app_dir)
    tripped = {
        proc: v for proc, v in verdicts.items()
        if v.get("verdict") == "tripped"
    }
    rules: dict[str, int] = {}
    for v in tripped.values():
        for rule, info in (v.get("rules") or {}).items():
            rules[rule] = rules.get(rule, 0) + int(
                (info or {}).get("trips", 1) or 1
            )
    if tripped or bundles:
        verdict = "tripped"
    elif verdicts:
        verdict = "healthy"
    else:
        verdict = "unknown"
    return {
        "verdict": verdict,
        "procs": verdicts,
        "rules": rules,
        "bundles": bundles,
    }


__all__ = [
    "ENV_ENABLED", "ENV_NAN_STEP", "ENV_SAMPLE", "ENV_WINDOW",
    "HealthRules", "HealthSentinel", "RULES", "active_sentinel",
    "batch_fingerprint", "decode_monitors", "due", "fingerprint_sum", "forensics_files",
    "graph_monitors", "install", "install_from_env", "layer_grad_rms",
    "layer_sq_sums", "monitors_from_sums", "nan_inject_step", "nonfinite_count",
    "read_verdicts", "rollup", "sample", "sq_norm", "uninstall",
]
