"""Convert a NVIDIA network-snapshot pickle into a checkpoint of the port.

    python -m gantrack_tpu_torch.tools.import_torch_pickle \\
        --src=network-snapshot-005000.pkl --dst=<dir> [--reference=<stylegan3 checkout>]

Port of ``gantrack_tpu/tools/import_torch_pickle.py`` (``argparse``
here; reference ``legacy.py:22-59``).  Unpickling a reference snapshot
needs the reference's ``torch_utils`` / ``dnnlib`` on the path
(``--reference`` or ``GANTRACK_REFERENCE``), as the snapshot embeds its
classes' source.  The networks' architecture comes from the pickle
(``models.torch_compat.architecture_from_pickle``: ``init_kwargs``, else
the tensor shapes), so StyleGAN3 snapshots and claro's widths (cbase
16384, cmax 512) convert, where the JAX tool infers ``cbase`` from the
4² width and builds a StyleGAN2 generator for any pickle (ROADMAP C14).
Writes ``<dst>/state-00000000.pt`` (fresh optimizers, as a reference
resume) with the architecture beside the state, which ``train --resume``
and every ``--network`` tool read.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m gantrack_tpu_torch.tools.import_torch_pickle",
                                description="Convert a NVIDIA G/D/G_ema pickle to a checkpoint.")
    p.add_argument("--src", required=True, help="network-snapshot-*.pkl")
    p.add_argument("--dst", required=True, help="output checkpoint directory")
    p.add_argument("--reference", default=None,
                   help="path to a stylegan3 checkout providing torch_utils/dnnlib")
    return p


def build_networks(arch: dict):
    """The port's G and D of a pickle's architecture, on the CPU."""
    from ..models.stylegan2 import Discriminator
    from .train import make_generator

    G = make_generator(arch["cfg"], resolution=arch["resolution"], channels=arch["channels"],
                       c_dim=arch["c_dim"], cbase=arch["cbase"], cmax=arch["cmax"],
                       map_depth=arch["map_depth"], num_fp16_res=arch["num_fp16_res"],
                       z_dim=arch["z_dim"], w_dim=arch["w_dim"], conv_clamp=arch["conv_clamp"],
                       num_layers=arch["num_layers"])
    D = Discriminator(c_dim=arch["c_dim"], img_resolution=arch["resolution"],
                      img_channels=arch["channels"], channel_base=arch["d_cbase"],
                      channel_max=arch["d_cmax"], num_fp16_res=arch["num_fp16_res"],
                      conv_clamp=arch["conv_clamp"],
                      epilogue_kwargs=dict(mbstd_group_size=arch["mbstd_group"],
                                           mbstd_num_channels=arch["mbstd_channels"]))
    return G, D


def main(argv: Optional[List[str]] = None) -> str:
    """Parse ``argv`` and convert; returns the checkpoint written."""
    from ..models.torch_compat import (architecture_from_pickle, load_network_pickle,
                                       transplant_into_state)
    from ..training.train_state import create_train_state
    from ..utils.checkpoint import save_checkpoint

    opts = build_parser().parse_args(argv)
    g_t, d_t, g_ema_t = load_network_pickle(opts.src, opts.reference)
    arch = architecture_from_pickle(g_ema_t, d_t)
    print(f"G: {arch['cfg']} res={arch['resolution']} ch={arch['channels']} "
          f"c_dim={arch['c_dim']} z={arch['z_dim']} w={arch['w_dim']} cbase={arch['cbase']} "
          f"cmax={arch['cmax']} map_depth={arch['map_depth']}")
    G, D = build_networks(arch)
    state = create_train_state(G, D, 0.0025, 0.0025,
                               g_reg_interval=4 if arch["cfg"] == "stylegan2" else None,
                               d_reg_interval=16)
    transplant_into_state(state, g_t, d_t, g_ema_t)
    path = save_checkpoint(opts.dst, state, extra={"architecture": arch})
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    main(sys.argv[1:])
