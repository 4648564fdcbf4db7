"""The open-loop load harness of the port's Serve (port of
ray_tpu/serve/loadgen.py) against the reference: from the same seed
both packages give the same arrival offsets (every arrival model, with
bursts), the same ``PromptMix`` payloads, percentiles and report
(tests/test_loadgen.py:70, :87, :95); the HTTP sender maps 503 to shed
with its Retry-After (:146); an open-loop run accounts for every offered
request; and ``python -m ray_tpu_torch.serve.loadgen`` self-deploys its
echo app on the port's runtime and writes its record.
"""

import itertools
import json
import os
import random
import subprocess
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from ray_tpu.serve import loadgen as ref
from ray_tpu_torch.serve import loadgen as port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONFIGS = [
    dict(rate=100.0, arrival="poisson"),
    dict(rate=100.0, arrival="lognormal", sigma=1.5),
    dict(rate=50.0, arrival="pareto", pareto_alpha=1.2),
    dict(rate=50.0, arrival="uniform", burst_factor=5.0,
         burst_every_s=1.0, burst_len_s=0.5),
    dict(rate=20.0, arrival="lognormal", burst_factor=4.0,
         burst_every_s=0.3, burst_len_s=0.1),
]


@pytest.mark.parametrize("fields", CONFIGS)
def test_arrival_offsets_match_reference(fields):
    offsets = {}
    for name, mod in (("port", port), ("ref", ref)):
        it = mod.arrival_offsets(mod.LoadgenConfig(**fields),
                                 random.Random(7))
        offsets[name] = [next(it) for _ in range(2000)]
    assert offsets["port"] == offsets["ref"]
    gaps = [b - a for a, b in zip([0.0] + offsets["port"], offsets["port"])]
    assert all(g >= 0.0 for g in gaps)


def test_unknown_arrival_raises_like_reference():
    for mod in (port, ref):
        with pytest.raises(ValueError, match="bogus"):
            next(mod.arrival_offsets(mod.LoadgenConfig(arrival="bogus"),
                                     random.Random(0)))


@pytest.mark.parametrize("fields", [
    dict(prefix_groups=3, prefix_len=48, unique_len=6,
         model_ids=("m1", "m2")),
    dict(prefix_groups=0, model_ids=("a",)),
    dict(prefix_groups=5, prefix_len=200, unique_len=12),
])
def test_prompt_mix_matches_reference(fields):
    payloads = {}
    for name, mod in (("port", port), ("ref", ref)):
        rng = random.Random(1)
        mix = mod.PromptMix(mod.LoadgenConfig(**fields), rng)
        payloads[name] = [mix.make(i, rng) for i in range(24)]
    assert payloads["port"] == payloads["ref"]
    if fields["prefix_groups"] == 3:
        p0, p3 = payloads["port"][0]["prompt"], payloads["port"][3]["prompt"]
        assert p0 != p3 and p0.rsplit(" ", 1)[0] == p3.rsplit(" ", 1)[0]
        assert [p["model"] for p in payloads["port"][:4]] == \
            ["m1", "m2", "m1", "m2"]


def _samples(mod, seed):
    rng = random.Random(seed)
    out = []
    for _ in range(200):
        kind = rng.choice(["ok", "ok", "ok", "shed", "error"])
        if kind == "ok":
            out.append(mod._Sample("ok", latency_s=rng.random(),
                                   ttft_s=rng.random() / 4
                                   if rng.random() < 0.5 else None))
        elif kind == "shed":
            out.append(mod._Sample(
                "shed", retry_after_s=rng.random()
                if rng.random() < 0.7 else None))
        else:
            out.append(mod._Sample("error"))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_report_matches_reference(seed):
    reports = {}
    for name, mod in (("port", port), ("ref", ref)):
        cfg = mod.LoadgenConfig(rate=10.0)
        r = mod._build_report(cfg, _samples(mod, seed), offered=210,
                              wall_s=3.5, peak_depth=seed)
        reports[name] = (r.to_dict(), r.format(),
                         mod._bench_record(cfg, r))
    assert reports["port"] == reports["ref"]
    d = reports["port"][0]
    assert d["ok"] + d["shed"] + d["errors"] == 200


def test_percentile_matches_reference():
    vals = [float(i) for i in range(1, 101)]
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert port._percentile(vals, q) == ref._percentile(vals, q)
    assert port._percentile([], 0.5) is None


def test_run_load_open_loop_with_fake_sender():
    """No cluster: a sender that sheds every third request. Every
    offered request is accounted for."""
    counter = itertools.count()

    def sender(payload):
        assert "seq" in payload
        if next(counter) % 3 == 2:
            return "shed", None, 0.25
        return "ok", None, None

    cfg = port.LoadgenConfig(rate=200.0, duration_s=0.5, arrival="uniform",
                             concurrency=4, timeout_s=5.0)
    r = port.run_load(cfg, sender)
    assert r.offered == r.ok + r.shed + r.errors and r.offered >= 50
    assert 0.2 < r.shed_rate < 0.45 and r.errors == 0
    assert r.p99_ms is not None and r.p99_ms >= 0.0

    def boom(payload):
        raise RuntimeError("boom")

    r = port.run_load(port.LoadgenConfig(
        rate=100.0, duration_s=0.2, arrival="uniform", concurrency=2,
        timeout_s=2.0), boom)
    assert r.errors == r.offered > 0


def test_http_sender_maps_503_to_shed():
    class H(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            self.rfile.read(int(self.headers.get("Content-Length", 0)))
            if self.path == "/shed":
                self.send_response(503)
                self.send_header("Retry-After", "2")
                self.end_headers()
                self.wfile.write(b"{}")
            elif self.path == "/fail":
                self.send_response(500)
                self.end_headers()
                self.wfile.write(b"{}")
            else:
                self.send_response(200)
                self.end_headers()
                self.wfile.write(b"{\"ok\": true}")

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        for mod in (port, ref):
            ok = mod.http_sender(f"{url}/ok")({})
            assert ok[0] == "ok" and ok[1] is not None
            assert mod.http_sender(f"{url}/shed")({}) == ("shed", None, 2.0)
            assert mod.http_sender(f"{url}/fail")({}) == ("error", None,
                                                          None)
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_cli_self_deploys_and_writes_its_record(tmp_path):
    """``python -m ray_tpu_torch.serve.loadgen``: the echo app on the
    port's runtime, lognormal arrivals with a burst, a prefix mix and
    two model ids; the record's counts add up."""
    out = tmp_path / "loadgen.json"
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    proc = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.serve.loadgen",
         "--rate", "30", "--duration", "2", "--arrival", "lognormal",
         "--burst-factor", "3", "--burst-every", "1", "--burst-len",
         "0.2", "--prefix-groups", "3", "--model-ids", "m1,m2",
         "--replicas", "2", "--max-ongoing", "8", "--max-queued", "32",
         "--work-ms", "2", "--json", str(out)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "achieved" in proc.stdout and "p99" in proc.stdout
    rec = json.loads(out.read_text())
    assert rec["bench"] == "serve_loadgen"
    report = rec["report"]
    assert report["offered"] == (report["ok"] + report["shed"]
                                 + report["errors"]) > 0
    assert report["errors"] == 0
    assert report["max_queue_depth"] <= 32
    metrics = {p["metric"]: p["value"] for p in rec["parsed"]}
    assert "serve_p99_latency" in metrics and metrics["serve_req_per_s"] > 0
