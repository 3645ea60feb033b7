"""The examples' command line: ``[--smoke] [--device DEVICE]``, run with
the dataset downloader off."""

from __future__ import annotations

import argparse
import contextlib
import os


@contextlib.contextmanager
def offline():
    """``DL4J_TPU_AUTO_DOWNLOAD=0`` for the block: the fetchers read local
    files or fall back to their synthetic surrogates, never the network."""
    prev = os.environ.get("DL4J_TPU_AUTO_DOWNLOAD")
    os.environ["DL4J_TPU_AUTO_DOWNLOAD"] = "0"
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("DL4J_TPU_AUTO_DOWNLOAD", None)
        else:
            os.environ["DL4J_TPU_AUTO_DOWNLOAD"] = prev


def run(main, description: str = "") -> None:
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--smoke", action="store_true",
                        help="a quick, shrunken run")
    parser.add_argument("--device", default="cuda",
                        help="the device to run on (default: cuda)")
    args = parser.parse_args()
    with offline():
        main(smoke=args.smoke, device=args.device)
