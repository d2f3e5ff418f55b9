"""Serve an LM with batched requests (the decode path), in PyTorch.

Builds a qwen2-0.5b-family model (or ``--arch``) with random weights from a
seed, feeds a batch of prompts token by token through the ring-buffer KV
cache (or the SSD state) and generates new tokens greedily with
``repro_torch.train.step.build_serve_step`` — the step ``input_specs``
describes for ``decode_32k`` / ``long_500k``.  The cache is written in
place and the position is a 0-d tensor on the device, so a step reads
nothing back to the host.  Runs on a CUDA device unless ``--device cpu``
is passed; prints tokens/s beside the card's name and power limit.

    PYTHONPATH=src python examples/torch_serve_lm.py               # GPU, reduced (d_model 256)
    PYTHONPATH=src python examples/torch_serve_lm.py --full        # GPU, published width, bf16
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu  # CPU, reduced
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu --arch mamba2-2.7b
"""

import argparse
import dataclasses
import subprocess
import time

import torch

from repro_torch.configs import get_config
from repro_torch.models import LM
from repro_torch.train.step import build_serve_step


def card(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them (the
    device's type on the CPU)."""
    if device.type != "cuda":
        return device.type
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return torch.cuda.get_device_name(device)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--full", action="store_true",
                    help="the published width (default: reduced, d_model 256)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="'cpu' to ask for the CPU (default: cuda)")
    args = ap.parse_args(argv)
    device = torch.device(args.device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to serve on "
                           "the CPU")

    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced(d_model=256)
    if cfg.n_experts:       # serve drop-free, as serving engines do
        cfg = dataclasses.replace(cfg, capacity_factor=16.0)
    model = LM(cfg)
    params = model.init(0, device=device)
    print(f"{cfg.name}: {cfg.param_count() / 1e6:.1f}M params "
          f"({cfg.arch_type}, {cfg.dtype}); batch={args.batch}; "
          f"device {card(device)}")

    gen = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen).to(device)
    cache = model.init_cache(args.batch, args.prompt_len + args.new_tokens,
                             device=device)
    serve = build_serve_step(model)
    index = torch.zeros((), dtype=torch.int64, device=device)

    # ---- prefill: the prompts fed token by token through the cache
    sync(device)
    t0 = time.perf_counter()
    for i in range(args.prompt_len):
        next_tok, cache = serve(params, cache, prompts[:, i:i + 1], index)
        index += 1
    sync(device)
    prefill_s = time.perf_counter() - t0
    print(f"prefilled {args.prompt_len} positions in {prefill_s:.2f}s")

    # ---- decode: batched greedy generation
    t0 = time.perf_counter()
    out = []
    for _ in range(args.new_tokens):
        out.append(next_tok)
        next_tok, cache = serve(params, cache, next_tok[:, None], index)
        index += 1
    sync(device)
    dt = time.perf_counter() - t0
    gen_tokens = torch.stack(out, dim=1).cpu()
    rate = args.batch * args.new_tokens / dt
    print(f"generated {args.new_tokens} tokens/request in {dt:.2f}s "
          f"({rate:.1f} tok/s batched; {dt / args.new_tokens * 1e3:.2f} "
          f"ms/step) on {card(device)}")
    print("sampled continuations (greedy):")
    for b in range(args.batch):
        print(f"  req{b}: {gen_tokens[b][:10].tolist()} ...")
    return {"prompts": prompts.cpu(), "generated": gen_tokens,
            "tokens_per_second": rate, "prefill_seconds": prefill_s,
            "decode_seconds": dt}


if __name__ == "__main__":
    main()
