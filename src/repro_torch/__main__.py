"""`python -m repro_torch` — the port's command line, a shell over
`repro_torch.api`.

    python -m repro_torch train --arch qwen3-1.7b --full --steps 4 \
        --global-batch 2 --seq 2048
    python -m repro_torch serve --arch qwen3-1.7b --full --tokens 16

Runs on the CUDA card unless ``--device cpu`` is given.
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
    s = sub.add_parser("serve", help="gateway prefill + token-by-token "
                                     "decode on the card")
    cli.add_arch_arg(s)
    cli.add_scale_args(s)
    cli.add_serve_args(s)
    return p


def _cmd_train(args) -> int:
    from repro_torch.core.trainer import MembershipEvent

    session = cli.session_from_args(args)
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


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return {"train": _cmd_train, "serve": _cmd_serve}[args.cmd](args)
    except NoCudaDevice as e:
        # no CUDA device and no --device cpu: a clean error, exit 2
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
