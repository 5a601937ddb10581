"""Batched serving example: prefill + decode with int8 KV cache.

    PYTHONPATH=src python -m repro_torch.examples.serve_batch [--arch mamba2-1.3b] [--device cpu]

The port's twin of the JAX package's ``examples/serve_batch.py``: the
reduced model through ``repro_torch.launch.serve`` with the JAX example's
flags, on ``--device`` (the CUDA card unless ``--device cpu`` is given).
On the card every prefill attention layer goes through K1 and every
Mamba-2 layer through K2.
"""
import argparse

from repro_torch.launch import serve as serve_mod


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return serve_mod.main(["--arch", args.arch, "--reduced", "--batch", "4",
                           "--prompt-len", "32", "--gen", str(args.gen),
                           "--kv-dtype", "int8" if args.arch != "mamba2-1.3b"
                           else "bfloat16", "--device", args.device])


if __name__ == "__main__":
    main()
