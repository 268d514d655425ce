"""Generation CLI: prefill a prompt batch, then greedy flash-decode.

Port of ``triton_distributed_tpu/tools/generate.py`` on one GPU: build a
preset model with random weights drawn from ``--seed``, prefill a random
prompt batch into contiguous KV caches in one pass, and greedy-decode
through the flash-decode kernels, reporting prefill and decode times::

    python -m triton_distributed_tpu_torch.tools.generate \\
        --preset llama_7b --batch 8 --prompt-len 1024 --steps 64

Weights are drawn in the preset's compute dtype (bf16 for the full-size
presets), and presets with ``dense_weight_quant`` draw and quantize each
matrix on the device. MoE presets (``deepseek_moe_16b``,
``mixtral_8x7b``) prefill through their MoE blocks and decode EP blocks
over the persistent workspaces of ``init_decode_state``, threaded
through the warm step and ``generate``. ``--tp N`` runs the
tensor-parallel path over a loopback mesh of N ranks on the device (the
counterpart of the JAX CLI's all-devices ``tp`` mesh), dense and MoE
presets alike: an EP preset splits its experts over the ranks and runs
its all-to-all across them, a TP one (``moe="tp"``) splits the experts'
F dim::

    python -m triton_distributed_tpu_torch.tools.generate \
        --preset deepseek_moe_16b --tp 4 --batch 4 --prompt-len 512

It runs on the card unless ``--device cpu`` is given. ``main(argv)``
returns the timings as a dict.
"""

from __future__ import annotations

import argparse
import dataclasses
import inspect
import time


def _config(name: str):
    from triton_distributed_tpu_torch.models import presets

    factories = {n: f for n, f in vars(presets).items()
                 if inspect.isfunction(f) and f.__module__ == presets.__name__}

    def resolve(n):
        if n not in factories:
            raise SystemExit(f"unknown preset {n!r}; available: "
                             f"{sorted(factories)} (or tiny:<name>)")
        return factories[n]

    if name.startswith("tiny:"):
        return presets.tiny(resolve(name.split(":", 1)[1])())
    return resolve(name)()


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--preset", default="tiny",
                   help="models.presets factory name (tiny, llama_7b, "
                        "llama_70b, ...; tiny:<name> = the test-sized twin "
                        "of <name>'s topology)")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=64)
    p.add_argument("--steps", type=int, default=32)
    p.add_argument("--capacity", type=int, default=None,
                   help="KV cache capacity (default prompt+steps rounded "
                        "up to 128)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA device)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ranks: above 1, a loopback mesh of "
                        "that many ranks on the device")
    args = p.parse_args(argv)

    import torch

    from triton_distributed_tpu_torch.models import Transformer
    from triton_distributed_tpu_torch.runtime import Mesh

    cfg = _config(args.preset)
    cfg = dataclasses.replace(cfg, param_dtype=cfg.dtype)
    mesh = None
    if args.tp > 1:
        mesh = Mesh.loopback(args.tp, args.device)
        print(f"mesh: loopback, {args.tp} ranks along 'tp' on {mesh.device}")
    model = Transformer(cfg, mesh=mesh, device=args.device)
    dev = model.device
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = model.init(gen, quantize=cfg.dense_weight_quant is not None)
    params = model.quantize_moe_weights(params)
    if mesh is not None:
        params = model.shard_params(params)
    cap = args.capacity or -(-(args.prompt_len + args.steps) // 128) * 128
    prompt = torch.randint(
        0, cfg.vocab, (args.batch, args.prompt_len), dtype=torch.int32,
        generator=torch.Generator(device=dev).manual_seed(args.seed + 1),
        device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # persistent workspaces of the EP MoE decode (None for other models)
    moe_state = model.init_decode_state(args.batch)
    # one warm prefill and decode step on throwaway caches, so that the
    # timings below leave out the kernels' build and first launches; the
    # MoE states are threaded on from the warm step
    warm, wc, wl = model.prefill(params, model.init_cache(args.batch, cap),
                                 prompt)
    res = model.decode_step(params, wc, wl,
                            torch.argmax(warm, -1).to(torch.int32),
                            moe_state=moe_state)
    if moe_state is not None:
        moe_state = res[3]
    del warm, wc, wl, res
    sync()

    caches = model.init_cache(args.batch, cap)
    t0 = time.perf_counter()
    last, caches, lens = model.prefill(params, caches, prompt)
    sync()
    t_prefill = time.perf_counter() - t0
    first = torch.argmax(last, dim=-1).to(torch.int32)
    t0 = time.perf_counter()
    toks = model.generate(params, caches, lens, first, args.steps,
                          moe_state=moe_state)[0].cpu()
    t_decode = time.perf_counter() - t0
    res = dict(preset=args.preset, device=str(dev), tp=args.tp,
               batch=args.batch,
               prompt_len=args.prompt_len, steps=args.steps,
               prefill_ms=t_prefill * 1e3, decode_ms=t_decode * 1e3,
               ms_per_step=t_decode / args.steps * 1e3,
               tok_s=args.batch * args.steps / t_decode,
               tokens=toks.tolist())
    print(f"preset={args.preset} device={dev} tp={args.tp} B={args.batch} "
          f"prompt={args.prompt_len} steps={args.steps}")
    print(f"prefill: {res['prefill_ms']:.1f} ms "
          f"({args.batch * args.prompt_len / t_prefill:.0f} tok/s)")
    print(f"decode:  {res['decode_ms']:.1f} ms ({res['tok_s']:.0f} tok/s, "
          f"{res['ms_per_step']:.2f} ms/step)")
    print("sample completion ids:", toks[0, :min(8, args.steps)].tolist())
    return res


if __name__ == "__main__":
    main()
