"""The port's headline benchmark: 256px generator forward throughput on one
GPU, the counterpart of the JAX package's ``bench.py`` at the repository
root.

    python3 -m confignet_tpu_torch.apps.bench [--device cuda|cpu]

The bf16 ``HologanGenerator`` at the reference's widths (145-dim latent,
weights from a seeded ``torch.Generator``) renders a batch of 256 latents at
the reference's head poses (yaw +-30deg, pitch +-10deg, roll 0; numpy seed
0) 20 times, ``out = G(z + i * 1e-6, rot)``, summing each output on the
device; one warm run, then a timed run that ends at the sum's ``.item()``.
``value`` is that eager rate in img/s, which is how the port's server runs;
``graph_img_s`` is the same loop captured once in a CUDA graph and replayed,
with no host dispatch inside (as bench.py's one jitted ``fori_loop``).
Every forward must launch the rotation kernel once and the AdaIN kernel six
times (for the graph: the launches made into its capture, counted at its
replay).  Prints one JSON line, with the card's name and power limit and the
peak memory; TF32 is off.  Without a
card, and without ``--device cpu``, it exits 2.
"""
from __future__ import annotations

import argparse
import sys

import torch

from confignet_tpu_torch.apps.bench_train import generator_throughput, turn_tf32_off

METRIC = "generator_fwd_256_throughput"
BATCH, N_ITERS = 256, 20


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default; fails without a card) or cpu")
    args = parser.parse_args(argv)
    if args.device is None and not torch.cuda.is_available():
        print("bench: no CUDA device; pass --device cpu to run on the CPU", file=sys.stderr)
        return 2
    turn_tf32_off()
    generator_throughput([], METRIC, 256, BATCH, N_ITERS, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
