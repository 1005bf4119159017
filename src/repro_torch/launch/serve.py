"""Serving launcher: bring up the batched serving loop for an arch.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama_1_1b \
        --batch 4 --max-len 128 --requests 6 [--full] [--device cpu]

``--full`` serves the architecture at its published widths in its own
dtype; without it ``small_config`` scales it down to ``--d-model``,
``--layers`` and ``--vocab`` in fp32 (a hybrid's ``--layers`` must be a
multiple of its ``shared_attn_every``).  Weights are random, drawn from
seed 0 on the device, which is the card unless ``--device cpu`` is given.
Every family but ``encdec`` serves here; the serving loop passes tokens
only, so an encoder-decoder fails for want of ``frames``, as in the JAX
package.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.launch.train import small_config
from repro_torch.models import registry
from repro_torch.serve import engine


def make_requests(cfg, n: int, max_new_tokens: int) -> list[engine.Request]:
    """``n`` requests with prompts of 4-11 tokens in [1, vocab), drawn from
    ``np.random.default_rng(0)`` as the JAX package's launcher draws
    them."""
    rng = np.random.default_rng(0)
    return [engine.Request(
        uid=i,
        prompt=rng.integers(1, cfg.vocab, size=int(rng.integers(4, 12))
                            ).astype(np.int32),
        max_new_tokens=max_new_tokens)
        for i in range(n)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama_1_1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve(args.device)
    base = registry.load_arch(args.arch)
    cfg = base if args.full else small_config(base, args.d_model, args.layers,
                                              args.vocab)
    params = registry.init_params(torch.Generator(device=dev).manual_seed(0),
                                  cfg, device=dev)
    loop = engine.ServeLoop(cfg, params, batch_size=args.batch,
                            max_len=args.max_len)
    reqs = make_requests(cfg, args.requests, args.max_new_tokens)
    for start in range(0, len(reqs), args.batch):
        batch = reqs[start:start + args.batch]
        for r in loop.run(batch):
            print(f"req {r.uid}: {len(r.generated)} tokens")
    print("done")


if __name__ == "__main__":
    main()
