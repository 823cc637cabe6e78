"""The JAX package's four examples on the port, each a module run as
`python -m repro_torch.examples.<name>`: quickstart, elastic_scaling,
fault_tolerance and serve_demo. Each takes --device (the card by
default; --device cpu for the kernels' plain versions) and refuses to
run on a missing card, as the CLIs do."""
import argparse
import tempfile


def device_args(description: str,
                ckpt: bool = True) -> argparse.ArgumentParser:
    """The parser every example starts from: --device, and --ckpt-dir
    (default a new temporary directory) for the training examples."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu")
    if ckpt:
        ap.add_argument("--ckpt-dir", default=None,
                        help="checkpoint root (default: a new temporary "
                        "directory); a checkpoint already there is "
                        "resumed from")
    return ap


def check_device(device: str) -> None:
    """Refuse a CUDA device when there is none (no CPU fallback)."""
    import torch
    if device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu for the plain "
                         "versions of the kernels")


def ckpt_root(args) -> str:
    return args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_example_")
