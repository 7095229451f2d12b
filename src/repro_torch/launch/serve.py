"""Production serving launcher: the k-of-n selection service.

  PYTHONPATH=src python -m repro_torch.launch.serve --requests 8 --solver cobi
  PYTHONPATH=src python -m repro_torch.launch.serve --workload mixed --encoder-stage
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --requests 3

Serves through the continuous engine API: every request is ``submit()``-ed
(admission-controlled enqueue returning a ``ResponseFuture``) and responses
stream back in completion order.  ``--workload`` picks what is served --
``summarize`` (default), any zoo workload (``dedup`` / ``rerank`` /
``multidoc``), or ``mixed`` (round-robin over all four); every workload
reduces to the same k-of-n formulation and flows through admission and
routing unchanged.  ``--encoder-stage`` fronts the farm with the batched
transformer ``EncoderStage`` (tiny config) so encodes pipeline against
anneals and encode energy shows up on the per-request bill.  ``--max-queue-depth`` bounds admitted
work (excess submissions are rejected with ``EngineOverloadedError`` and
reported), the overload posture of a real deployment.  ``--route`` puts the
cost-model backend router above admission (COBI farm only): farm overload
spills onto the host pool instead of shedding, with per-backend
latency/energy/quality predictions from ``--profile`` (a
``CalibrationProfile`` JSON from ``python -m repro_torch.launch.calibrate``:
the H100's is
``src/repro_torch/serving/profiles/CALIBRATION_cobi_pool_h100.json``, a
single run's fit, whose medians moved 20-45% between two runs; its
``CALIBRATION_mcmc_h100.json`` beside it reads the Tabu pool as free at n 2,
where its quadratic is negative; default: the built-in hardware-constant
profile).  Everything runs on
``--device`` (default ``cuda``, the card; ``cpu`` runs the kernels' plain
versions).
"""

from __future__ import annotations

import argparse

from repro_torch.core import SolveConfig
from repro_torch.data.synthetic import synthetic_document
from repro_torch.serving import AdmissionConfig, EngineOverloadedError, SummarizationEngine
from repro_torch.workloads import build_request

_MIX = ("summarize", "dedup", "rerank", "multidoc")


def _build_request(workload: str, i: int, m: int):
    """One synthetic request of the given zoo workload (seeded by index)."""
    if workload == "mixed":
        workload = _MIX[i % len(_MIX)]
    sents = synthetic_document(i, 20 + (i % 3) * 15)
    if workload == "summarize":
        return build_request("summarize", text=" ".join(sents), m=m)
    if workload == "dedup":
        return build_request("dedup", items=sents, keep=m)
    if workload == "rerank":
        return build_request("rerank", query=sents[0], candidates=sents[1:],
                             k=m)
    docs = [" ".join(synthetic_document(10 * i + j, 8)) for j in range(3)]
    return build_request("multidoc", documents=docs, m=m)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--solver", default="cobi", choices=["cobi", "tabu", "sa"])
    ap.add_argument("--workload", default="summarize",
                    choices=["summarize", "dedup", "rerank", "multidoc",
                             "mixed"],
                    help="zoo workload to serve (mixed = round-robin)")
    ap.add_argument("--encoder-stage", action="store_true",
                    help="front the farm with the batched transformer "
                         "EncoderStage (tiny config) instead of the host "
                         "bag-of-words encoder")
    ap.add_argument("--m", type=int, default=6)
    ap.add_argument("--iterations", type=int, default=6)
    ap.add_argument("--max-queue-depth", type=int, default=0,
                    help="admission cap on in-flight requests (0 = unbounded)")
    ap.add_argument("--route", action="store_true",
                    help="cost-model backend routing above admission "
                         "(spill farm overload to the host pool)")
    ap.add_argument("--route-objective", default="min-energy",
                    choices=["min-energy", "min-latency", "weighted"])
    ap.add_argument("--profile", default=None,
                    help="CalibrationProfile JSON for --route, e.g. "
                         "src/repro_torch/serving/profiles/"
                         "CALIBRATION_cobi_pool_h100.json, the H100's "
                         "single-run fit (its medians moved 20-45%% between "
                         "two runs; default: built-in hardware-constant "
                         "profile)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome-trace/Perfetto JSON of the run, "
                         "stamped in Unix-epoch microseconds like a "
                         "torch.profiler trace (open in ui.perfetto.dev or "
                         "chrome://tracing)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write a Prometheus text snapshot of the unified "
                         "metrics registry at exit")
    ap.add_argument("--device", default="cuda",
                    help="where the engine, its backends and the encoder "
                         "stage run (cuda, or cpu for the kernels' plain "
                         "versions)")
    ap.add_argument("--no-trace", action="store_true",
                    help="disable span/event tracing (the registry stays "
                         "live; responses are bit-identical either way)")
    args = ap.parse_args()

    admission = (AdmissionConfig(max_queue_depth=args.max_queue_depth)
                 if args.max_queue_depth > 0 else None)
    encoder = None
    if args.encoder_stage:
        from repro_torch.embeddings import EncoderStage

        encoder = EncoderStage.tiny(max_len=512, device=args.device)
        encoder.prewarm(lengths=[256, 512])
    engine = SummarizationEngine(
        SolveConfig(solver=args.solver, iterations=args.iterations, reads=8,
                    int_range=14, p=20, q=10),
        encoder=encoder,
        admission=admission,
        routing=args.route,
        route_objective=args.route_objective,
        profile=args.profile,
        tracing=not args.no_trace,
        device=args.device,
    )
    futures, rejected = [], 0
    for i in range(args.requests):
        req = _build_request(args.workload, i, args.m)
        try:
            futures.append(engine.submit_request(req))
        except EngineOverloadedError:
            rejected += 1
    for fut in futures:
        resp = fut.result(timeout=600.0)
        enc = (f", enc={resp.encoder_joules * 1e3:.1f}mJ"
               if resp.encoder_joules > 0 else "")
        print(
            f"req {resp.request_id} [{resp.workload}]: "
            f"{len(resp.selected)} selected, "
            f"obj={resp.objective:.3f}, wall={resp.wall_seconds * 1e3:.0f}ms, "
            f"projected={resp.projected_solver_seconds * 1e3:.2f}ms/"
            f"{resp.projected_energy_joules * 1e3:.3f}mJ, "
            f"xfer={(resp.bytes_h2d + resp.bytes_d2h) / 1024:.0f}KiB"
            + enc
            + (f", via {resp.backend_used}" if resp.backend_used else "")
        )
    if rejected:
        print(f"{rejected} request(s) shed by admission control")
    if engine.router is not None:
        print(f"router: {engine.router.stats()}")
    obs = engine.stats()["obs"]
    print(f"obs: tracing={obs['tracing']} "
          f"unclosed_spans={obs['unclosed_spans']} "
          f"dropped_events={obs['dropped_events']}")
    if args.trace_out:
        from repro_torch.obs import validate_chrome_trace, write_chrome_trace

        doc = write_chrome_trace(engine.obs.tracer, args.trace_out,
                                 clock="unix")
        print(f"trace: {validate_chrome_trace(doc)} events "
              f"-> {args.trace_out}")
    if args.metrics_out:
        from repro_torch.obs import prometheus_text

        with open(args.metrics_out, "w") as fh:
            fh.write(prometheus_text(engine.obs.registry))
        print(f"metrics -> {args.metrics_out}")
    engine.close()


if __name__ == "__main__":
    main()
