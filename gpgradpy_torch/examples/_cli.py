"""The examples' shared command line: ``--device cuda|cpu``."""

import argparse


def device_arg(description: str) -> str:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="torch device of the models (default: cuda)")
    return ap.parse_args().device
