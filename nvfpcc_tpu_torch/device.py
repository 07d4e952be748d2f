"""Device resolution and the numerics every reconstruction runs under.

``--platform cpu`` means the CPU (tests, small drives); ``default`` and
``device`` mean the CUDA card and raise when there is none. Nothing falls
back to the CPU silently: a run that asked for the card either gets it or
fails.
"""

from __future__ import annotations

import subprocess

import torch

PLATFORMS = ("default", "cpu", "device")


def resolve_device(platform: str = "default") -> torch.device:
    """``cpu`` -> the CPU; ``default``/``device`` -> ``cuda`` (raises if absent)."""
    if platform == "cpu":
        return torch.device("cpu")
    if platform not in PLATFORMS:
        raise ValueError(f"unknown platform {platform!r}; expected one of {PLATFORMS}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"--platform {platform} needs a CUDA device and torch sees none "
            "(pass --platform cpu to run on the host)"
        )
    return torch.device("cuda")


def card_line(device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` prints them (its first card), or ``cpu`` for
    the host: the line a measurement is reported beside."""
    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def set_numerics() -> None:
    """Pin the card's float math to what the codec's parity contract needs
    (called by the codec before it computes latents or reconstructs).

    - TF32 off for convs and matmuls: cuDNN runs f32 convs in TF32 by
      default, which keeps about 3 decimal digits and would move voxels
      across the decode threshold ``thh``.
    - ``cudnn.benchmark`` off and ``deterministic`` on: the encode process
      and the decode process must pick the same conv algorithms, so that
      ``rc_enc == rc_dec`` holds bit for bit across processes.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True


def set_train_numerics() -> None:
    """The float math training runs under (called by ``train.loop.train``).

    TF32 stays off: the rate terms and the f32 compute path are sensitive to
    it. Training needs no bit equality across processes, so cuDNN may pick
    its algorithms freely, unless the caller turned on
    ``torch.use_deterministic_algorithms`` (two runs that must agree bit for
    bit). The codec calls :func:`set_numerics` before every reconstruction,
    so nothing set here reaches a later encode or decode in the same process.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = torch.are_deterministic_algorithms_enabled()
