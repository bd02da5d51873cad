"""Runnable examples of the port (ports of the JAX package's
``examples/*.py``), each on the CUDA card by default::

    python -m rescan_line_sted_torch.examples.quickstart [--platform cpu]
    python -m rescan_line_sted_torch.examples.ism [--platform cpu]
    python -m rescan_line_sted_torch.examples.optimal_rescan [--platform cpu]
    python -m rescan_line_sted_torch.examples.polarization [--platform cpu]
"""

import argparse

import torch

from rescan_line_sted_torch.device import resolve


def device_from_args(argv=None, description: str = "") -> torch.device:
    """The device an example runs on: ``--platform cpu`` or ``cuda``;
    without the flag the CUDA card (no card is an error)."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--platform", choices=["cpu", "cuda"], default=None,
                        help="device (default: the CUDA card)")
    return resolve(parser.parse_args(argv).platform)
