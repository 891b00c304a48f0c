"""Where the port's entry points put their tensors.

Every public entry point that takes a `device` defaults to "cuda": the port
runs on the card unless the caller asks for the CPU (the tests pass
device="cpu"). `resolve` turns the argument into a torch.device and refuses a
CUDA device that this process cannot reach, with a clear error instead of
a silent fall-back to the CPU.
"""

import torch


def resolve(device) -> torch.device:
    """`device` (a string or torch.device) -> canonical torch.device, e.g.
    "cuda" -> cuda:0. Raises RuntimeError when it names CUDA and no CUDA
    device is available."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r}: no CUDA device is available. The port runs on the "
                "GPU by default; pass device=\"cpu\" to run its plain PyTorch versions "
                "on the CPU."
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
