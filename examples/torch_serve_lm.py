"""Batched LM serving demo on the PyTorch port: prefill + cached decode
with the serving engine (fixed decode batch, greedy sampling).

    PYTHONPATH=src python examples/torch_serve_lm.py [--arch ID] [--device cpu]

The architecture (tinyllama-1.1b unless ``--arch`` names another of
``registry.ARCH_IDS``) scaled down to width 128 in fp32, 2 layers (a
hybrid: one group of its shared-attention period), random weights from
seed 0, on the card unless ``--device cpu`` is given.  The serving loop
passes tokens only, so an encoder-decoder is driven through the engine's
prefill and decode steps over precomputed frames instead.
"""
import argparse

import numpy as np
import torch

from repro_torch.launch.train import small_config
from repro_torch.models import registry
from repro_torch.serve import engine


def serve_encdec(cfg, params, dev, prompts, new_tokens):
    """Left-padded prompts over 16 random frames each, greedy decode."""
    plen = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), plen), np.int32)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p):] = p
    gen = torch.Generator(device=dev).manual_seed(0)
    frames = torch.randn((len(prompts), 16, cfg.d_model), generator=gen,
                         device=dev)
    prefill = engine.build_prefill_step(cfg, max_len=plen + new_tokens)
    decode = engine.build_decode_step(cfg)
    with torch.inference_mode():
        logits, cache = prefill(params, {
            "tokens": torch.from_numpy(toks).to(dev), "frames": frames})
        token = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        out = [token[:, 0].tolist()]
        for _ in range(new_tokens - 1):
            step = decode(params, {"token": token, "cache": cache})
            token, cache = step["next_token"][:, None], step["cache"]
            out.append(token[:, 0].tolist())
    return [list(col) for col in zip(*out)]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tinyllama_1_1b",
                    choices=registry.ARCH_IDS)
    ap.add_argument("--device", default="cuda",
                    help="where the model's weights and cache live")
    args = ap.parse_args()
    dev = torch.device(args.device)

    base = registry.load_arch(args.arch)
    cfg = small_config(base, d_model=128,
                       layers=base.shared_attn_every or 2, vocab=512)
    params = registry.init_params(torch.Generator(device=dev).manual_seed(0),
                                  cfg, device=dev)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 512, size=n).astype(np.int32)
               for n in (5, 9, 3, 7)]
    if cfg.family == "encdec":
        for i, g in enumerate(serve_encdec(cfg, params, dev, prompts, 8)):
            print(f"request {i}: prompt[{len(prompts[i])}] -> {len(g)} "
                  f"tokens: {g}")
        print("encoder-decoder serving complete")
        return

    loop = engine.ServeLoop(cfg, params, batch_size=4, max_len=64)
    requests = [engine.Request(uid=i, prompt=p, max_new_tokens=8 + 4 * i)
                for i, p in enumerate(prompts)]
    done = loop.run(requests)
    for r in done:
        print(f"request {r.uid}: prompt[{len(r.prompt)}] -> "
              f"{len(r.generated)} tokens: {r.generated}")
    assert all(r.done for r in done)
    print("serving loop complete")


if __name__ == "__main__":
    main()
