"""`python -m repro_torch` — the port's command line, a shell over
`repro_torch.api`.

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
    s = sub.add_parser("serve", help="gateway prefill + token-by-token "
                                     "decode on the card")
    cli.add_arch_arg(s)
    cli.add_scale_args(s)
    cli.add_serve_args(s)
    return p


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
        return {"serve": _cmd_serve}[args.cmd](args)
    except NoCudaDevice as e:
        # no CUDA device and no --device cpu: a clean error, exit 2
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
