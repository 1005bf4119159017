"""End-to-end LM training with the PyTorch port: a ~100M-parameter
llama-family model trained for a few hundred steps on the deterministic
synthetic corpus, with checkpoint/restart supervision.  Loss must drop
substantially.

    PYTHONPATH=src python examples/torch_train_lm_100m.py [--steps 300]
    PYTHONPATH=src python examples/torch_train_lm_100m.py --tiny --device cpu

The model trains on the card unless ``--device cpu`` is given; ``--tiny``
is a seconds-long smoke run (2 layers, d_model 128); ``--checkpoint-dir
''`` trains without checkpoints.
"""
import argparse
import math

import numpy as np
import torch

from repro_torch.launch.train import run_training, small_config
from repro_torch.models import registry
from repro_torch.tree import leaves


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--checkpoint-dir", default="artifacts/lm100m_ckpt")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    base = registry.load_arch("llama3_2_3b")
    if args.tiny:
        cfg = small_config(base, d_model=128, layers=2, vocab=512)
        batch, seq = 8, 64
    else:
        # ~100M: 14L x d640 (d_ff 2560) + 16k vocab
        cfg = small_config(base, d_model=640, layers=14, vocab=16384)
        batch, seq = 2, 256
    meta = registry.init_params(torch.Generator(), cfg, device="meta")
    n_params = sum(math.prod(t.shape) for t in leaves(meta))
    print(f"model: {cfg.name} scaled to {n_params/1e6:.1f}M params")

    # data vocab 512 << model vocab: a few hundred steps of synthetic chain
    # are enough to show a decisive loss drop
    out = run_training(cfg, steps_n=args.steps, global_batch=batch,
                       seq_len=seq, lr=1e-3, data_vocab=512,
                       checkpoint_dir=args.checkpoint_dir or None,
                       checkpoint_every=100, log_every=10,
                       device=args.device)
    losses = out["losses"]
    first = float(np.mean(losses[:10]))
    last = float(np.mean(losses[-10:]))
    print(f"loss: {first:.3f} -> {last:.3f}")
    assert last < first - 0.5, "loss did not drop"
    print("OK")


if __name__ == "__main__":
    main()
