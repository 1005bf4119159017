"""Batched LM serving demo on the PyTorch port: prefill + KV-cache decode
with the serving engine (fixed decode batch, greedy sampling).

    PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]

tinyllama-1.1b scaled down to 2 layers of width 128 in fp32, random
weights from seed 0, on the card unless ``--device cpu`` is given.
"""
import argparse

import numpy as np
import torch

from repro_torch.launch.train import small_config
from repro_torch.models import registry
from repro_torch.serve import engine


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the model's weights and cache live")
    args = ap.parse_args()
    dev = torch.device(args.device)

    base = registry.load_arch("tinyllama_1_1b")
    cfg = small_config(base, d_model=128, layers=2, vocab=512)
    params = registry.init_params(torch.Generator(device=dev).manual_seed(0),
                                  cfg, device=dev)

    loop = engine.ServeLoop(cfg, params, batch_size=4, max_len=64)
    rng = np.random.default_rng(0)
    requests = [
        engine.Request(uid=i,
                       prompt=rng.integers(1, 512, size=n).astype(np.int32),
                       max_new_tokens=8 + 4 * i)
        for i, n in enumerate((5, 9, 3, 7))
    ]
    done = loop.run(requests)
    for r in done:
        print(f"request {r.uid}: prompt[{len(r.prompt)}] -> "
              f"{len(r.generated)} tokens: {r.generated}")
    assert all(r.done for r in done)
    print("serving loop complete")


if __name__ == "__main__":
    main()
