"""Serving entry point: replay a prompt batch through the decode step, then
decode greedily or by temperature with the KV/recurrent cache.  Port of
``src/repro/launch/serve.py``: reduced configs, run on the CUDA card unless
``--device cpu``; the full configs' steps go through the dry-run."""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.models import build_model, supports_decode
from repro_torch.numerics import set_fp32_policy


def sample_tokens(logits: torch.Tensor, gen: torch.Generator,
                  temperature: float) -> torch.Tensor:
    """The next token (B, 1) int32 from the last position's logits: the
    argmax at temperature <= 0, else a draw from softmax(logits / T) by
    ``gen``."""
    last = logits[:, -1, :].float()
    if temperature <= 0:
        return last.argmax(dim=-1)[:, None].to(torch.int32)
    probs = torch.softmax(last / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=gen).to(torch.int32)


@torch.no_grad()
def generate(model, params, lora, batch: dict, new_tokens: int, temperature: float,
             gen: torch.Generator) -> torch.Tensor:
    """The reference's serving loop: a fixed-size cache of prompt +
    ``new_tokens`` slots (and the VLM's vision prefix), the prompt replayed
    through ``serve_step`` one token at a time from ``pos0`` (the VLM's
    text starts after its vision tokens), then ``new_tokens`` sampled
    tokens, each fed back.  As in the reference, the replay reads only the
    tokens: the VLM's embeddings and the encoder-decoder's frames are made
    by ``run`` and not read.  Returns the new tokens (B, new_tokens)."""
    cfg = model.cfg
    tokens = batch["tokens"]
    b, prompt_len = tokens.shape
    pos0 = cfg.n_vision_tokens if cfg.family == "vlm" else 0
    cache = model.init_cache(b, pos0 + prompt_len + new_tokens)
    logits = None
    for i in range(prompt_len):
        logits, cache = model.serve_step(params, lora, cache, tokens[:, i:i + 1], pos0 + i)
    out = []
    tok = sample_tokens(logits, gen, temperature)
    for i in range(new_tokens):
        out.append(tok[:, 0])
        logits, cache = model.serve_step(params, lora, cache, tok, pos0 + prompt_len + i)
        tok = sample_tokens(logits, gen, temperature)
    return torch.stack(out, dim=1)


def run(args):
    cfg = get_config(args.arch)
    if not supports_decode(cfg):
        raise SystemExit(f"{args.arch} is encoder-only: no decode step")
    if args.reduced:
        cfg = reduced(cfg, n_layers=args.layers, d_model=args.d_model)
    device = resolve_device(args.device)
    model = build_model(cfg, device)
    gen = torch.Generator(device=device)
    params = model.init_params(gen.manual_seed(args.seed))
    lora = model.init_lora(gen.manual_seed(args.seed + 1))

    b = args.batch
    gen.manual_seed(args.seed)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, args.prompt_len), generator=gen,
                                     device=device, dtype=torch.int32)}
    act = params["embed"].dtype
    if cfg.family == "vlm":
        batch["vision_embeds"] = torch.zeros((b, cfg.n_vision_tokens, cfg.vision_embed_dim),
                                             dtype=act, device=device)
    if cfg.family == "encdec":
        batch["frames"] = torch.zeros((b, cfg.encoder_seq, cfg.d_model), dtype=act,
                                      device=device)

    t0 = time.time()
    out = generate(model, params, lora, batch, args.new_tokens, args.temperature, gen)
    gen_tokens = out.cpu().numpy()          # waits for the device
    dt = time.time() - t0
    print(f"[{args.arch}] generated {gen_tokens.shape} tokens in {dt:.2f}s "
          f"({args.new_tokens*b/dt:.1f} tok/s total)")
    print("first sequence:", gen_tokens[0][:32].tolist())
    return gen_tokens


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    set_fp32_policy()
    run(args)


if __name__ == "__main__":
    main()
