"""Open-loop serve load harness: heavy-tailed traffic against the
full chain (proxy -> router -> replica -> engine) (port of
ray_tpu/serve/loadgen.py).

Reference: the coordinated-omission discipline of wrk2/Lago — an
OPEN-loop generator schedules arrivals from the traffic model alone
and measures each request's latency from its *scheduled* arrival
time, never from when a worker thread got around to sending it. A
closed-loop client (send, wait, send) silently self-throttles under
overload and reports fantasy p99s; this one keeps firing and lets the
admission controller do the shedding it exists for.

Traffic model:

- inter-arrival times drawn from poisson (exponential), lognormal, or
  pareto distributions — the latter two heavy-tailed, matching
  production inference traffic where a few clients batch-submit;
- burst episodes: every ``burst_every_s`` of *virtual* (scheduled)
  time, ``burst_len_s`` seconds run at ``burst_factor``x the base
  rate, exercising EWMA overload detection and SLO autoscaling;
- prefix-shared prompt mix: ``prefix_groups`` distinct long prefixes
  with per-request unique suffixes, so a prefix_aware router has
  real affinity structure to exploit;
- mixed model IDs round-robined from ``model_ids``, exercising the
  multiplex LRU when the target handler is ``@multiplexed``.

Outputs offered/achieved req/s, p50/p95/p99 latency, TTFT
percentiles (stream mode), shed rate, and exact peak queue depth
(via ``AdmissionController.take_max_queue_depth``).

CLI (self-deploys an echo app on the local runtime):

    python -m ray_tpu_torch.serve.loadgen --rate 50 --duration 10 \
        --arrival lognormal --burst-factor 4 --json loadgen.json
"""

from __future__ import annotations

import argparse
import json
import math
import queue
import random
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

ARRIVALS = ("poisson", "lognormal", "pareto", "uniform")


@dataclass
class LoadgenConfig:
    rate: float = 20.0             # offered req/s (mean)
    duration_s: float = 5.0
    arrival: str = "poisson"       # one of ARRIVALS
    sigma: float = 1.0             # lognormal shape (ln-space stddev)
    pareto_alpha: float = 1.5      # pareto tail index (>1 for finite mean)
    burst_factor: float = 1.0      # >1 enables burst episodes
    burst_every_s: float = 0.0     # virtual-time period between bursts
    burst_len_s: float = 0.0       # burst duration within each period
    prefix_groups: int = 0         # 0 disables prefix-shared prompts
    prefix_len: int = 64
    unique_len: int = 8
    model_ids: Tuple[str, ...] = ()
    stream: bool = False
    concurrency: int = 32          # sender threads (not a rate limiter)
    timeout_s: float = 30.0
    seed: int = 0


@dataclass
class LoadReport:
    offered: int = 0
    ok: int = 0
    shed: int = 0
    errors: int = 0
    duration_s: float = 0.0
    offered_rps: float = 0.0
    achieved_rps: float = 0.0
    p50_ms: Optional[float] = None
    p95_ms: Optional[float] = None
    p99_ms: Optional[float] = None
    ttft_p50_ms: Optional[float] = None
    ttft_p99_ms: Optional[float] = None
    shed_rate: float = 0.0
    max_queue_depth: Optional[int] = None
    retry_after_mean_s: Optional[float] = None

    def to_dict(self) -> Dict[str, Any]:
        return dict(self.__dict__)

    def format(self) -> str:
        def ms(v):
            return "-" if v is None else f"{v:8.1f}"
        lines = [
            f"offered   {self.offered:7d} req "
            f"({self.offered_rps:.1f} req/s over {self.duration_s:.2f}s)",
            f"achieved  {self.ok:7d} ok ({self.achieved_rps:.1f} req/s), "
            f"{self.shed} shed ({100 * self.shed_rate:.1f}%), "
            f"{self.errors} errors",
            f"latency   p50 {ms(self.p50_ms)} ms   "
            f"p95 {ms(self.p95_ms)} ms   p99 {ms(self.p99_ms)} ms",
        ]
        if self.ttft_p50_ms is not None:
            lines.append(f"ttft      p50 {ms(self.ttft_p50_ms)} ms   "
                         f"p99 {ms(self.ttft_p99_ms)} ms")
        if self.max_queue_depth is not None:
            lines.append(f"queue     max depth {self.max_queue_depth}")
        if self.retry_after_mean_s is not None:
            lines.append(
                f"backoff   mean Retry-After {self.retry_after_mean_s:.2f}s")
        return "\n".join(lines)


# -- traffic model ----------------------------------------------------------


def _draw_gap(cfg: LoadgenConfig, rng: random.Random) -> float:
    """One inter-arrival gap with mean 1/rate, per the configured
    distribution."""
    mean = 1.0 / max(cfg.rate, 1e-9)
    if cfg.arrival == "poisson":
        return rng.expovariate(1.0 / mean)
    if cfg.arrival == "lognormal":
        # E[lognormal(mu, sigma)] = exp(mu + sigma^2/2) == mean
        mu = math.log(mean) - cfg.sigma ** 2 / 2.0
        return rng.lognormvariate(mu, cfg.sigma)
    if cfg.arrival == "pareto":
        # paretovariate(a) has mean a/(a-1); scale so E[gap] == mean
        a = max(cfg.pareto_alpha, 1.001)
        xm = mean * (a - 1.0) / a
        return xm * rng.paretovariate(a)
    if cfg.arrival == "uniform":
        return mean
    raise ValueError(f"unknown arrival distribution {cfg.arrival!r}; "
                     f"expected one of {ARRIVALS}")


def arrival_offsets(cfg: LoadgenConfig, rng: random.Random):
    """Yield scheduled arrival offsets (seconds from start), forever.
    Burst episodes compress gaps by burst_factor inside windows of
    VIRTUAL time — the schedule itself, not the wall clock — so the
    burst pattern is deterministic for a given seed."""
    t = 0.0
    while True:
        gap = _draw_gap(cfg, rng)
        if (cfg.burst_factor > 1.0 and cfg.burst_every_s > 0.0
                and (t % cfg.burst_every_s) < cfg.burst_len_s):
            gap /= cfg.burst_factor
        t += gap
        yield t


class PromptMix:
    """Request payload generator: prefix-shared prompts + mixed model
    IDs. Every payload carries ``prompt`` (and ``model`` when
    model_ids were configured) so prefix_aware routing and multiplex
    both see realistic structure."""

    _WORDS = ("graft", "mesh", "shard", "tile", "lane", "core", "host",
              "fuse", "pin", "spill")

    def __init__(self, cfg: LoadgenConfig, rng: random.Random):
        self.cfg = cfg
        self._prefixes: List[str] = []
        for g in range(max(0, cfg.prefix_groups)):
            words = [self._WORDS[rng.randrange(len(self._WORDS))]
                     for _ in range(max(1, cfg.prefix_len // 6))]
            self._prefixes.append(f"sys{g}: " + " ".join(words))

    def make(self, seq: int, rng: random.Random) -> Dict[str, Any]:
        payload: Dict[str, Any] = {"seq": seq}
        if self._prefixes:
            prefix = self._prefixes[seq % len(self._prefixes)]
            suffix = "".join(
                chr(ord("a") + rng.randrange(26))
                for _ in range(self.cfg.unique_len))
            payload["prompt"] = f"{prefix} {suffix}"
        if self.cfg.model_ids:
            payload["model"] = self.cfg.model_ids[
                seq % len(self.cfg.model_ids)]
        return payload


# -- senders ----------------------------------------------------------------
#
# A sender takes a payload and returns (outcome, t_first, retry_after):
# outcome in {"ok", "shed", "error"}; t_first is the absolute monotonic
# time of the first response item (TTFT anchor) or None; retry_after is
# the server-suggested backoff on shed, or None.

Sender = Callable[[Dict[str, Any]],
                  Tuple[str, Optional[float], Optional[float]]]


def handle_sender(handle, *, stream: bool = False,
                  timeout_s: float = 30.0) -> Sender:
    """Drive a DeploymentHandle; BackpressureError counts as shed."""
    from ray_tpu_torch.serve.admission import BackpressureError
    h = handle.options(stream=stream) if stream else handle

    def send(payload):
        try:
            if stream:
                t_first = None
                for _ in h.remote(payload):
                    if t_first is None:
                        t_first = time.monotonic()
                return "ok", t_first, None
            h.remote(payload).result(timeout_s=timeout_s)
            return "ok", None, None
        except BackpressureError as exc:
            return "shed", None, exc.retry_after_s

    return send


def http_sender(url: str, *, timeout_s: float = 30.0) -> Sender:
    """Drive the HTTP proxy; 503 counts as shed (Retry-After header
    parsed when present)."""
    import urllib.error
    import urllib.request

    def send(payload):
        body = json.dumps(payload).encode()
        req = urllib.request.Request(
            url, data=body, headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=timeout_s) as resp:
                first = resp.read(1)
                t_first = time.monotonic() if first else None
                resp.read()
            return "ok", t_first, None
        except urllib.error.HTTPError as exc:
            if exc.code == 503:
                retry_after = None
                try:
                    retry_after = float(exc.headers.get("Retry-After"))
                except (TypeError, ValueError):
                    pass
                exc.read()
                return "shed", None, retry_after
            return "error", None, None
        except (OSError, urllib.error.URLError):
            return "error", None, None

    return send


# -- the harness ------------------------------------------------------------


@dataclass
class _Sample:
    outcome: str
    latency_s: Optional[float] = None
    ttft_s: Optional[float] = None
    retry_after_s: Optional[float] = None


def _percentile(sorted_vals: List[float], q: float) -> Optional[float]:
    if not sorted_vals:
        return None
    pos = (len(sorted_vals) - 1) * q
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(sorted_vals) - 1)
    return sorted_vals[lo] + (sorted_vals[hi] - sorted_vals[lo]) * (pos - lo)


def run_load(cfg: LoadgenConfig, sender: Sender,
             admission=None) -> LoadReport:
    """Run the open-loop schedule against ``sender``; returns the
    report. ``admission`` (an AdmissionController) enables exact peak
    queue depth readout — its peak counter is reset at start."""
    rng = random.Random(cfg.seed)
    mix = PromptMix(cfg, rng)
    # Payload randomness comes from a second stream so arrival draws
    # stay identical whether or not prompts are enabled.
    payload_rng = random.Random(cfg.seed + 1)
    work: "queue.Queue" = queue.Queue()
    samples: List[_Sample] = []
    samples_lock = threading.Lock()

    if admission is not None:
        admission.take_max_queue_depth()  # reset the peak counter

    def worker():
        while True:
            item = work.get()
            if item is None:
                return
            t_sched, payload = item
            try:
                outcome, t_first, retry_after = sender(payload)
            except Exception:  # noqa: BLE001 — one bad request != abort
                outcome, t_first, retry_after = "error", None, None
            t_end = time.monotonic()
            s = _Sample(outcome=outcome, retry_after_s=retry_after)
            if outcome == "ok":
                # Latency anchored at the SCHEDULED arrival, so time a
                # request spent waiting for a free sender thread (i.e.
                # the overload we induced) is charged to the system.
                s.latency_s = max(0.0, t_end - t_sched)
                if t_first is not None:
                    s.ttft_s = max(0.0, t_first - t_sched)
            with samples_lock:
                samples.append(s)

    workers = [threading.Thread(target=worker, daemon=True)
               for _ in range(max(1, cfg.concurrency))]
    for w in workers:
        w.start()

    offered = 0
    t_start = time.monotonic()
    for offset in arrival_offsets(cfg, rng):
        if offset > cfg.duration_s:
            break
        t_fire = t_start + offset
        delay = t_fire - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        work.put((t_fire, mix.make(offered, payload_rng)))
        offered += 1
    for _ in workers:
        work.put(None)
    deadline = time.monotonic() + cfg.timeout_s + 5.0
    for w in workers:
        w.join(timeout=max(0.1, deadline - time.monotonic()))
    wall_s = time.monotonic() - t_start

    peak_depth = (admission.take_max_queue_depth()
                  if admission is not None else None)
    with samples_lock:
        done = list(samples)
    return _build_report(cfg, done, offered, wall_s, peak_depth)


def _build_report(cfg: LoadgenConfig, samples: List[_Sample],
                  offered: int, wall_s: float,
                  peak_depth: Optional[int]) -> LoadReport:
    ok = [s for s in samples if s.outcome == "ok"]
    shed = [s for s in samples if s.outcome == "shed"]
    errors = [s for s in samples if s.outcome == "error"]
    lat = sorted(s.latency_s for s in ok if s.latency_s is not None)
    ttft = sorted(s.ttft_s for s in ok if s.ttft_s is not None)
    retry = [s.retry_after_s for s in shed if s.retry_after_s is not None]
    finished = max(1, len(samples))
    r = LoadReport(
        offered=offered, ok=len(ok), shed=len(shed), errors=len(errors),
        duration_s=wall_s,
        offered_rps=offered / max(wall_s, 1e-9),
        achieved_rps=len(ok) / max(wall_s, 1e-9),
        shed_rate=len(shed) / finished,
        max_queue_depth=peak_depth)
    for name, q in (("p50_ms", 0.50), ("p95_ms", 0.95), ("p99_ms", 0.99)):
        v = _percentile(lat, q)
        setattr(r, name, None if v is None else v * 1000.0)
    for name, q in (("ttft_p50_ms", 0.50), ("ttft_p99_ms", 0.99)):
        v = _percentile(ttft, q)
        setattr(r, name, None if v is None else v * 1000.0)
    if retry:
        r.retry_after_mean_s = sum(retry) / len(retry)
    return r


# -- CLI: self-deployed echo app --------------------------------------------


class EchoServer:
    """Minimal handler for CLI runs: optional simulated work, echoes
    the model id back so multiplex mixes are visible in responses.
    Module-level so replica actors can unpickle it by reference."""

    def __init__(self, work_ms: float = 0.0):
        self.work_ms = float(work_ms)

    def __call__(self, request: Optional[Dict[str, Any]] = None):
        if self.work_ms > 0.0:
            time.sleep(self.work_ms / 1000.0)
        request = request or {}
        return {"ok": True, "seq": request.get("seq"),
                "model": request.get("model")}


def _bench_record(cfg: LoadgenConfig, report: LoadReport) -> Dict[str, Any]:
    parsed = [
        {"metric": "serve_req_per_s", "value": round(report.achieved_rps, 2),
         "unit": "req/s"},
        {"metric": "serve_shed_rate", "value": round(report.shed_rate, 4),
         "unit": "fraction"},
    ]
    if report.p99_ms is not None:
        parsed.insert(1, {"metric": "serve_p99_latency",
                          "value": round(report.p99_ms, 2), "unit": "ms"})
    return {
        "bench": "serve_loadgen",
        "config": dict(cfg.__dict__),
        "report": report.to_dict(),
        "parsed": parsed,
    }


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.serve.loadgen",
        description="Open-loop load harness for ray_tpu_torch.serve")
    p.add_argument("--rate", type=float, default=20.0)
    p.add_argument("--duration", type=float, default=5.0)
    p.add_argument("--arrival", choices=ARRIVALS, default="poisson")
    p.add_argument("--sigma", type=float, default=1.0)
    p.add_argument("--pareto-alpha", type=float, default=1.5)
    p.add_argument("--burst-factor", type=float, default=1.0)
    p.add_argument("--burst-every", type=float, default=0.0)
    p.add_argument("--burst-len", type=float, default=0.0)
    p.add_argument("--prefix-groups", type=int, default=0)
    p.add_argument("--model-ids", default="",
                   help="comma-separated model ids to round-robin")
    p.add_argument("--stream", action="store_true")
    p.add_argument("--concurrency", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--url", default=None,
                   help="hit an existing HTTP proxy instead of "
                        "self-deploying an echo app")
    p.add_argument("--replicas", type=int, default=2)
    p.add_argument("--max-ongoing", type=int, default=8)
    p.add_argument("--max-queued", type=int, default=64)
    p.add_argument("--work-ms", type=float, default=2.0,
                   help="simulated handler work (self-deploy mode)")
    p.add_argument("--json", dest="json_path", default=None,
                   help="write the run's JSON record (config, report, "
                        "metrics) here")
    args = p.parse_args(argv)

    cfg = LoadgenConfig(
        rate=args.rate, duration_s=args.duration, arrival=args.arrival,
        sigma=args.sigma, pareto_alpha=args.pareto_alpha,
        burst_factor=args.burst_factor, burst_every_s=args.burst_every,
        burst_len_s=args.burst_len, prefix_groups=args.prefix_groups,
        model_ids=tuple(m for m in args.model_ids.split(",") if m),
        stream=args.stream, concurrency=args.concurrency, seed=args.seed)

    if args.url:
        sender = http_sender(args.url)
        report = run_load(cfg, sender)
    else:
        import ray_tpu_torch
        from ray_tpu_torch import serve
        from ray_tpu_torch.serve.admission import get_admission_controller
        # Under ``python -m`` this file runs as __main__; pick up the
        # canonical import of EchoServer so replicas can unpickle it
        # by reference.
        from ray_tpu_torch.serve.loadgen import EchoServer as _Echo
        # The implicit init sizes the pool from os.cpu_count(); on a
        # small box that can be fewer slots than replicas, which would
        # leave the deployment UPDATING forever.
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(num_cpus=max(4, args.replicas + 1))
        router = "prefix_aware" if cfg.prefix_groups else "pow2"
        dep = serve.deployment(
            name="loadgen_echo", num_replicas=args.replicas,
            max_ongoing_requests=args.max_ongoing,
            max_queued_requests=args.max_queued,
            request_router=router)(_Echo)
        handle = serve.run(dep.bind(args.work_ms), name="loadgen")
        try:
            # Warm the router/admission config before measuring.
            handle.remote({"seq": -1}).result(timeout_s=30)
            sender = handle_sender(handle, stream=cfg.stream,
                                   timeout_s=cfg.timeout_s)
            admission = get_admission_controller("loadgen_echo")
            report = run_load(cfg, sender, admission=admission)
        finally:
            try:
                serve.shutdown()
                ray_tpu_torch.shutdown()
            except Exception:  # teardown
                pass

    print(report.format())
    if args.json_path:
        with open(args.json_path, "w") as f:
            json.dump(_bench_record(cfg, report), f, indent=2)
            f.write("\n")
        print(f"wrote {args.json_path}")
    return 0 if report.errors == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
