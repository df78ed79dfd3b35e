"""Serving entry point of the port: D-STACK multiplexed inference on one
GPU.

Two modes:
  * ``--mode sim``  — control-plane simulation on the H100 roofline
    latency model (any subset of the archs that fit one card, production
    rates); nothing runs on a device.
  * ``--mode real`` — end to end through the engine pool
    (``repro_torch.serving.pool``): real graphed prefill/decode through
    standby InferenceEngines, the chosen policy making every run decision
    (GPU%, batch, order). It runs on the CUDA device, at full width in
    bfloat16, and raises where there is none, unless ``--device cpu`` is
    given: then on reduced configs in float32, as the JAX package's
    ``launch.serve`` does.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --mode sim \
      --models qwen2-0.5b,mamba2-1.3b,deepseek-7b,yi-9b --duration 5
  PYTHONPATH=src python -m repro_torch.launch.serve --mode real \
      --models qwen2-0.5b,olmo-1b --duration 0.05 --policy dstack
"""
from __future__ import annotations

import argparse


def run_sim(model_names, duration: float, policy_name: str, rate: float):
    from repro_torch.core.profiles import build_profile
    from repro_torch.core.scheduler import POLICIES
    from repro_torch.core.simulator import SimConfig, Simulator
    from repro_torch.serving.request import RequestGenerator

    profiles, gens = {}, []
    for i, n in enumerate(model_names):
        p = build_profile(n, request_rate=rate)
        profiles[p.name] = p
        gens.append(RequestGenerator(p.name, rate, p.slo, seed=i))
        print(f"  {p.name:26s} knee={p.knee_chips:3d}% "
              f"opt=(b={p.opt_batch},{p.opt_chips}%) slo={p.slo*1e3:.0f}ms")
    policy = POLICIES[policy_name](profiles)
    res = Simulator(profiles, policy, gens, SimConfig(duration=duration)).run()
    print(f"policy={policy_name} throughput={res.throughput():.1f}/s "
          f"utilization={res.utilization:.3f} violations={res.total_violated}")
    for n, m in res.per_model.items():
        print(f"  {n:26s} thr={m.throughput(res.duration):8.1f}/s "
              f"violated={m.violated:5d} runtime={m.runtime:.2f}s")
    return res


def run_real(model_names, duration: float, policy_name: str, rate: float,
             gen_len: int = 4, lazy_kv: bool = False, device=None,
             trace_path=None, metrics: bool = False):
    """Thin wrapper over the engine pool: the named policy drives real
    graphed slot engines end to end (standby allocations captured once).
    ``lazy_kv`` switches admission to prompt-only page reservation with
    preempt-and-requeue on OutOfPages; ``device`` defaults to the CUDA
    device, where the models run at full width in bfloat16 (the reduced
    configs' shapes are not all built into the kernels); on the CPU they
    run reduced, in float32. ``trace_path`` arms the telemetry plane and
    writes a Perfetto-loadable Chrome trace there; ``metrics`` prints a
    Prometheus text snapshot of the run."""
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.serving.controller import run_policy
    from repro_torch.serving.pool import build_pool

    on_gpu = resolve_device(device).type == "cuda"
    pool = build_pool(model_names, request_rate=rate, base_slots=4,
                      cache_len=32, lazy_kv=lazy_kv, device=device,
                      reduced=not on_gpu,
                      dtype=torch.bfloat16 if on_gpu else torch.float32)
    for n, host in sorted(pool.hosts.items()):
        allocs = ", ".join(f"{a.chips}%/{a.n_slots}sl"
                           for a in host.allocations.values())
        print(f"  {n:26s} standby engines: {allocs} "
              f"on {host.api.device}")
    tel = None
    if trace_path or metrics:
        from repro_torch.serving.telemetry import Telemetry, TraceRecorder
        tel = Telemetry(trace=TraceRecorder() if trace_path else None)
        pool.attach_telemetry(tel)
    try:
        res = run_policy(pool, policy_name, rate=rate, duration=duration,
                         gen_len=gen_len)
    finally:
        if tel is not None:
            pool.attach_telemetry(None)
    for line in res.table_rows():
        print(line)
    if trace_path:
        tel.trace.save(trace_path)
        print(f"trace: {len(tel.trace.events)} events -> {trace_path} "
              f"(load in https://ui.perfetto.dev)")
    if metrics:
        from repro_torch.serving.telemetry import (MetricsRegistry,
                                                   export_pool_result)
        reg = MetricsRegistry()
        export_pool_result(reg, res)
        print(reg.render(), end="")
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mode", choices=["sim", "real"], default="sim")
    ap.add_argument("--models",
                    default="qwen2-0.5b,mamba2-1.3b,deepseek-7b,yi-9b")
    ap.add_argument("--policy", default="dstack")
    ap.add_argument("--duration", type=float, default=None,
                    help="virtual seconds (default: 5.0 sim, 0.05 real)")
    ap.add_argument("--rate", type=float, default=2000.0)
    ap.add_argument("--gen-len", type=int, default=4)
    ap.add_argument("--lazy-kv", action="store_true",
                    help="(real mode) lazy page reservation with "
                         "preempt-and-requeue on OutOfPages")
    ap.add_argument("--device", default=None,
                    help="(real mode) torch device (default: the CUDA "
                         "device; 'cpu' runs the plain versions)")
    ap.add_argument("--trace", nargs="?", const="trace.json", default=None,
                    metavar="PATH",
                    help="(real mode) record a Chrome/Perfetto trace of "
                         "the serve and write it to PATH "
                         "(default trace.json)")
    ap.add_argument("--metrics", action="store_true",
                    help="(real mode) print a Prometheus text snapshot "
                         "of the run")
    args = ap.parse_args()
    names = args.models.split(",")
    if args.mode == "sim":
        dur = args.duration if args.duration is not None else 5.0
        run_sim(names, dur, args.policy, args.rate)
    else:
        dur = args.duration if args.duration is not None else 0.05
        run_real(names, dur, args.policy, args.rate, gen_len=args.gen_len,
                 lazy_kv=args.lazy_kv, device=args.device,
                 trace_path=args.trace, metrics=args.metrics)


if __name__ == "__main__":
    main()
