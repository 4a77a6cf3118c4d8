"""`python -m repro_torch` — the port's command line, a shell over
`repro_torch.api`.

    python -m repro_torch train --arch qwen3-1.7b --full --steps 4 \
        --global-batch 2 --seq 2048
    python -m repro_torch train --mode async_ps --members 4 --steps 8
    python -m repro_torch serve --arch qwen3-1.7b --full --tokens 16
    python -m repro_torch serve --fleet --providers gcp,aws
    python -m repro_torch plan --score sim --engine jit [--provider aws]
    python -m repro_torch predict --gpu v100 --workers 4 [--provider azure]
    python -m repro_torch simulate --samples 65536 --engine jit
    python -m repro_torch chaos --scenario ps_crash --smoke [--no-live]
    python -m repro_torch dryrun --arch qwen3-1.7b --shape train_4k
    python -m repro_torch dryrun --sweep --jobs 3
    python -m repro_torch bench --only lm_speed_models,fig2_stability

Runs on the CUDA card unless ``--device cpu`` is given; `dryrun` counts
on the meta device and needs no device at all, nor do the bench modules
that need no model (the paper's tables, Figs 3, 4, 6, 11, 12, Eq (4)).
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from repro_torch.device import NoCudaDevice
from repro_torch.launch import cli


def build_parser():
    p = argparse.ArgumentParser(prog="repro_torch",
                                description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("train", help="elastic transient-aware training on "
                                     "the card")
    cli.add_arch_arg(t)
    cli.add_scale_args(t)
    cli.add_batch_args(t)
    cli.add_train_args(t)
    cli.add_resilience_args(t)
    cli.add_recalib_args(t)
    s = sub.add_parser("serve", help="gateway prefill + token-by-token "
                                     "decode on the card, or --fleet "
                                     "SLO-aware serving planning")
    cli.add_arch_arg(s)
    cli.add_scale_args(s)
    cli.add_serve_args(s)
    cli.add_serve_fleet_args(s)
    # resilience flags shape the --fleet plan (drain/handover vs stock)
    cli.add_resilience_args(s)
    for name, hlp in (("plan", "revocation-aware launch planning (§V-C); "
                               "--score sim --engine jit on the card"),
                      ("simulate", "discrete-event fleet simulation "
                                   "(§VI-A); --engine jit on the card"),
                      ("predict", "Eq (4)/(5) end-to-end prediction")):
        q = sub.add_parser(name, help=hlp)
        cli.add_arch_arg(q)
        cli.add_scale_args(q)
        cli.add_fleet_args(q)
        if name in ("plan", "simulate"):
            # predict is the Eq (4) closed form: no recovery term
            cli.add_resilience_args(q)
        q.add_argument("--steps", type=int, default=2000)
        q.add_argument("--checkpoint-interval", type=int, default=200)
        # --region defaults to None: `plan` scores every region of the
        # selected provider; simulate/predict fall back to the provider's
        # default region
        if name == "plan":
            q.add_argument("--samples", type=int, default=200,
                           help="Monte-Carlo draws per (region, hour) cell")
            q.add_argument("--score", default="eq4",
                           choices=("eq4", "sim"),
                           help="cell estimator: Eq (4) point estimate "
                                "(default) or a full fleet-simulation "
                                "ensemble per cell with time/cost "
                                "percentiles")
            q.add_argument("--engine", default="batched",
                           choices=("batched", "event", "jit"),
                           help="trajectory stepper for --score sim: the "
                                "lockstep NumPy engine (default), the "
                                "per-trajectory event loop, or the device "
                                "engine (on --device)")
            # planning is uncapped unless the user asks for the Fig 4 PS
            # model (--score sim always applies it, with 1 PS by default)
            q.set_defaults(n_ps=None)
        elif name == "simulate":
            q.add_argument("--samples", type=int, default=1,
                           help="trajectories; >1 reports the p50/p90/mean "
                                "ensemble summary (SimStats)")
            q.add_argument("--engine", default="batched",
                           choices=("batched", "event", "jit"),
                           help="ensemble stepper: the lockstep NumPy "
                                "engine (default), the per-trajectory event "
                                "loop, or the device engine (on --device)")
    c = sub.add_parser("chaos", help="scripted fault scenarios with "
                                     "ground-truth-scored detection & "
                                     "mitigation; the live runs train on "
                                     "the card")
    cli.add_arch_arg(c)
    cli.add_scale_args(c)
    c.add_argument("--scenario", default="all",
                   help="registered scenario name, or 'all' (default)")
    c.add_argument("--list", action="store_true",
                   help="list registered scenarios and exit")
    c.add_argument("--engine", default="batched",
                   choices=("batched", "event", "jit"),
                   help="fleet-ensemble stepper (an engine-vs-event "
                        "parity probe runs either way)")
    c.add_argument("--live", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="drive the real trainer through scenarios that "
                        "carry a live plan (--no-live: simulation only)")
    c.add_argument("--samples", type=int, default=32,
                   help="fleet-simulation trajectories per ensemble")
    c.add_argument("--smoke", action="store_true",
                   help="enforce each scenario's expectation gates; "
                        "exit 1 if any fail")
    # the recovery and recalibration flags arm session.run, which the
    # simulated fleets and the live trainer runs inherit
    cli.add_resilience_args(c)
    cli.add_recalib_args(c)
    b = sub.add_parser("bench", help="the paper's table/figure drivers "
                                     "(`name,value,derived` CSV rows); "
                                     "those that run a model run on the "
                                     "card")
    b.add_argument("--only", default="",
                   help="comma-separated benchmark module subset")
    b.add_argument("--list", action="store_true",
                   help="list available benchmark modules and exit")
    cli.add_device_arg(b)
    # `dryrun` is dispatched before argparse in main(): its flags are owned
    # by repro_torch.launch.dryrun (or repro_torch.launch.sweep under
    # --sweep). Registered here for `--help` only.
    sub.add_parser("dryrun", help="count (arch x shape) cells on the meta "
                                  "device and price them on the production "
                                  "meshes; --sweep fans out the full arch x "
                                  "shape matrix with resumable artifacts; "
                                  "flags forwarded to "
                                  "repro_torch.launch.dryrun / .sweep",
                   add_help=False)
    return p


def _cmd_train(args) -> int:
    from repro_torch.core.trainer import MembershipEvent

    session = cli.session_from_args(args)
    if args.mode == "async_ps":
        if args.revoke_at or args.checkpoint_dir:
            raise ValueError("--revoke-at/--checkpoint-dir apply to "
                             "--mode sync only (the async-PS emulation "
                             "has no checkpointing or membership events)")
        rep = session.train(args.steps, global_batch=args.global_batch,
                            seq_len=args.seq, members=args.members,
                            mode="async_ps")
        stale = session.bus.of_kind("staleness")[-1].payload
        curve = (f"loss {rep.losses[0]:.3f}->{rep.losses[-1]:.3f} "
                 if rep.losses else "")
        print(f"arch={args.arch} mode=async_ps updates={rep.steps_run} "
              f"{curve}staleness_hist={stale['hist']}")
        return 0
    events = []
    if args.revoke_at and args.members > 1:
        events.append(MembershipEvent(step=args.revoke_at, kind="revoke",
                                      member_id=args.members - 1))
    rep = session.train(args.steps, global_batch=args.global_batch,
                        seq_len=args.seq, members=args.members,
                        events=events, checkpoint_dir=args.checkpoint_dir)
    compressed = [e.payload for e in session.bus.of_kind("step")
                  if "payload_bytes" in e.payload]
    extra = (f" payload={compressed[-1]['payload_bytes']:.0f}B/"
             f"{compressed[-1]['grad_compression']}" if compressed else "")
    for ev in session.bus.of_kind("restore"):
        print(f"resumed from checkpoint at step {ev.payload['step']}")
    curve = (f"loss {rep.losses[0]:.3f}->{rep.losses[-1]:.3f} "
             if rep.losses else "")
    print(f"arch={args.arch} device={session.device} steps={rep.steps_run} "
          f"{curve}speed={rep.speed or 0:.2f} steps/s epochs={rep.epochs} "
          f"checkpoints={rep.checkpoints}{extra}")
    return 0


def _cmd_serve(args) -> int:
    session = cli.session_from_args(args)
    if args.fleet:
        from repro_torch.serving import ServingSLO, ServingWorkload
        workload = ServingWorkload(n_requests=args.requests,
                                   arrival_rate_per_s=args.rate,
                                   prompt_tokens=args.prompt_len,
                                   max_tokens=args.tokens)
        best, plans = session.plan_serving(
            replica_counts=tuple(int(x) for x in
                                 args.replica_counts.split(",")),
            providers=tuple(args.providers.split(",")),
            gpu=args.gpu, workload=workload,
            slo=ServingSLO(p99_latency_s=args.slo_p99),
            resilience=cli.resilience_from_args(args),
            samples=args.plan_samples, seed=args.seed)
        print(f"# serving plan: arch={args.arch} gpu={args.gpu} "
              f"slo_p99={args.slo_p99}s requests={args.requests} "
              f"@{args.rate}/s")
        for p in plans:
            mark = "*" if p is best else " "
            print(f"{mark} {p.provider:<7s} {p.region:<16s} "
                  f"x{p.replicas:<3d} slo={'ok ' if p.meets_slo else 'MISS'}"
                  f" p50={p.latency_p50_s:7.3f}s p99={p.latency_p99_s:7.3f}s"
                  f" completed={p.completed_frac:5.1%}"
                  f" shed={p.shed_frac:5.1%} drop={p.drop_frac:5.1%}"
                  f" ${p.cost_per_1k:.4f}/1k")
        return 0
    rep = session.serve(args.tokens, batch=args.batch,
                        prompt_len=args.prompt_len,
                        temperature=args.temperature, seed=args.seed)
    print(f"arch={args.arch} device={rep.device} batch={rep.batch} "
          f"prefill {rep.prompt_len} tok in {rep.prefill_seconds:.3f}s; "
          f"decode {rep.tokens_generated} tok in {rep.decode_seconds:.3f}s "
          f"({rep.tokens_per_second:.1f} tok/s)")
    print(f"decode latency per token: p50={rep.decode_ms_p50:.3f}ms "
          f"p95={rep.decode_ms_p95:.3f}ms p99={rep.decode_ms_p99:.3f}ms")
    print("sample tokens:", rep.sample_tokens)
    return 0


def _cmd_plan(args) -> int:
    session = cli.session_from_args(args)
    best, plans = session.plan(gpu=args.gpu, n_workers=args.workers,
                               steps=args.steps,
                               checkpoint_interval=args.checkpoint_interval,
                               region=args.region, seed=args.seed,
                               provider=args.provider, samples=args.samples,
                               score=args.score, engine=args.engine,
                               n_ps=args.n_ps)
    where = args.region or "all regions"
    what = ("simulated trajectories" if args.score == "sim" else "samples")
    print(f"arch={session.arch} provider={args.provider} gpu={args.gpu} "
          f"workers={args.workers} "
          f"({where}): scored {len(plans)} (region, hour) cells "
          f"x {args.samples} {what} [score={args.score}, "
          f"device={session.device}]")
    print(f"best: {best.region} @ {best.launch_hour:02d}h  "
          f"E[revocations]={best.expected_revocations:.2f}"
          f"±{best.revocation_stderr:.2f}  "
          f"E[time]={best.expected_time_s:.0f}s  "
          f"E[cost]=${best.expected_cost:.2f}")
    if args.score == "sim":
        print(f"      time p50={best.time_p50_s:.0f}s "
              f"p90={best.time_p90_s:.0f}s  "
              f"cost p50=${best.cost_p50:.2f} p90=${best.cost_p90:.2f}  "
              f"finished={best.finished}/{best.samples}")
    return 0


def _cmd_simulate(args) -> int:
    session = cli.session_from_args(args)
    res = session.simulate(n_workers=args.workers, gpu=args.gpu,
                           region=args.region, steps=args.steps,
                           checkpoint_interval=args.checkpoint_interval,
                           n_ps=args.n_ps, seed=args.seed,
                           provider=args.provider, samples=args.samples,
                           engine=args.engine)
    if args.samples > 1:
        st = res.stats
        print(f"arch={session.arch} {args.workers}x{args.gpu} on "
              f"{res.provider}/{res.region}: {st.n} trajectories "
              f"(engine={args.engine}, device={session.device})")
        if st.finished < st.n:
            print(f"WARNING: only {st.finished}/{st.n} trajectories "
                  f"finished all {args.steps} steps (censored at "
                  f"max_hours or fully revoked) — the time/cost summary "
                  f"understates the true distribution")
        print(f"time  p50={st.time_p50_s:.0f}s p90={st.time_p90_s:.0f}s "
              f"mean={st.time_mean_s:.0f}±{st.time_stderr_s:.0f}s")
        print(f"cost  p50=${st.cost_p50:.2f} p90=${st.cost_p90:.2f} "
              f"mean=${st.cost_mean:.2f}±{st.cost_stderr:.2f}")
        print(f"revocations p50={st.revocations_p50:.1f} "
              f"p90={st.revocations_p90:.1f} "
              f"mean={st.revocations_mean:.2f}")
        return 0
    print(f"arch={session.arch} {args.workers}x{args.gpu} on "
          f"{res.provider}/{res.region}: "
          f"{res.steps_done} steps in {res.total_time_s:.0f}s  "
          f"revocations={res.revocations} replacements={res.replacements} "
          f"ckpt={res.checkpoint_time_s:.0f}s cost=${res.monetary_cost:.2f}")
    return 0


def _cmd_predict(args) -> int:
    session = cli.session_from_args(args)
    rep = session.predict(n_workers=args.workers, gpu=args.gpu,
                          region=args.region, steps=args.steps,
                          checkpoint_interval=args.checkpoint_interval,
                          n_ps=args.n_ps, seed=args.seed,
                          provider=args.provider)
    print(f"arch={rep.arch} {rep.n_workers}x{rep.gpu} on "
          f"{rep.provider}/{rep.region}: "
          f"worker {rep.worker_speed:.2f} steps/s, cluster "
          f"{rep.cluster_speed:.2f} steps/s"
          f"{' (PS-bottlenecked)' if rep.ps_bottlenecked else ''}")
    print(f"Eq(4): {rep.total_time_seconds:.0f}s for {args.steps} steps  "
          f"(T_c={rep.checkpoint_seconds:.2f}s, "
          f"E[revocations]={rep.expected_revocations:.2f})")
    return 0


def _cmd_chaos(args) -> int:
    import json

    from repro_torch.chaos import list_scenarios

    if args.list:
        print("\n".join(list_scenarios()))
        return 0
    session = cli.session_from_args(args)
    card = session.chaos(args.scenario, engine=args.engine, live=args.live,
                         samples=args.samples, seed=args.seed,
                         smoke=args.smoke)
    print(json.dumps(card, indent=2, sort_keys=True))
    if args.smoke and not card["passed"]:
        fails = {name: c["smoke"]["failures"]
                 for name, c in card["scenarios"].items()
                 if not c["smoke"]["passed"]}
        print(f"chaos smoke gates FAILED: {fails}", file=sys.stderr)
        return 1
    return 0


def _cmd_bench(args) -> int:
    from repro_torch.bench import run as bench_run

    argv = ["--list"] if args.list else []
    if args.only:
        argv += ["--only", args.only]
    if args.device:
        argv += ["--device", args.device]
    return bench_run.main(argv)


def _cmd_dryrun(rest: List[str]) -> int:
    if "--sweep" in rest:
        from repro_torch.launch import sweep
        return sweep.main([a for a in rest if a != "--sweep"])
    from repro_torch.launch import dryrun
    dryrun.main(rest)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["dryrun"]:
        return _cmd_dryrun(argv[1:])
    args = build_parser().parse_args(argv)
    try:
        return {"train": _cmd_train, "serve": _cmd_serve, "plan": _cmd_plan,
                "simulate": _cmd_simulate, "predict": _cmd_predict,
                "chaos": _cmd_chaos, "bench": _cmd_bench}[args.cmd](args)
    except NoCudaDevice as e:
        # no CUDA device and no --device cpu: a clean error, exit 2
        print(f"error: {type(e).__name__}: {e}", file=sys.stderr)
        return 2
    except ValueError as e:
        # domain validation (e.g. a (region, gpu) cell the selected
        # provider never sold): reported cleanly, as the reference's CLI
        # does
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
