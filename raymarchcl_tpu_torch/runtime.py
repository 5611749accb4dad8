"""Host runtime: device selection and the kernel build with its log.

Counterpart of `raymarchcl_tpu/runtime.py` and of the reference's
simplecl usage (SURVEY.md E1): platform/device selection (core.clj:121-123
picks the max-FLOPS device) and program compilation with a printed build
log (core.clj:124-131). Here the program is the port's kernel library
(ops/kernels/build.py), and its log is nvcc's and ptxas's (registers,
spills, shared memory of each kernel). Devices are torch devices; the
CUDA card is the default, and asking for it without one raises.
"""

from __future__ import annotations

import subprocess

import torch


def select_platform() -> str:
    """'cuda' when a CUDA card is present, else 'cpu' (a report only: it
    selects nothing)."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def check_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device without a card raises
    instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to render on the CPU")
    return dev


def devices(platform=None) -> list:
    """The torch devices of `platform` (default 'cuda'): every CUDA card
    (raises without one), or the one CPU device for 'cpu'."""
    platform = platform or "cuda"
    if platform == "cpu":
        return [torch.device("cpu")]
    if platform != "cuda":
        raise ValueError(f"platform must be 'cuda' or 'cpu', got {platform!r}")
    check_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def max_device(platform=None) -> torch.device:
    """The card with the most SMs, the first of equals (the reference picks
    the max-FLOPS device, core.clj:122); the CPU for platform='cpu'."""
    devs = devices(platform)
    if devs[0].type == "cpu":
        return devs[0]
    sms = [torch.cuda.get_device_properties(d).multi_processor_count for d in devs]
    return devs[sms.index(max(sms))]


def card(device=None) -> str:
    """The name and power limit of `device`'s card as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them
    (`NVIDIA H100 80GB HBM3, 700.00 W`); every card's, one line a card, when
    `device` is None; 'cpu' for a CPU device; or why they could not be read.
    A card set below its maximum power runs slower under load, so every
    measurement carries it. The card is found by its UUID, so the line is
    the card's own even where CUDA numbers the cards otherwise."""
    dev = None if device is None else torch.device(device)
    if dev is not None and dev.type == "cpu":
        return "cpu"
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=uuid,name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e.__class__.__name__})"
    if smi.returncode != 0 or not smi.stdout.strip():
        return f"unavailable (rc {smi.returncode})"
    rows = [line.split(", ", 1) for line in smi.stdout.strip().splitlines()]
    if dev is None:
        return "\n".join(rest for _, rest in rows)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    uuid = str(getattr(torch.cuda.get_device_properties(index), "uuid", ""))
    for smi_uuid, rest in rows:
        if uuid and smi_uuid.removeprefix("GPU-") == uuid:
            return rest
    return rows[index][1] if index < len(rows) else f"unavailable (no card {index})"


def build(verbose=False):
    """Build (or load the cached build of) the kernel library, the analog
    of `cl/init-state` + build-log printing (core.clj:124-131). Returns the
    loaded library; prints build_log() when verbose."""
    from .ops.kernels import build as kbuild

    lib = kbuild.library()
    if verbose:
        print(build_log())
    return lib


def build_log() -> str:
    """Report of the kernel library this process loaded: its path, the
    compile seconds (0 for a cached build) and nvcc's output."""
    from .ops.kernels import build as kbuild

    info = kbuild.build_info
    lines = ["build log:", "-" * 19]
    if not info:
        lines.append("(no kernel library loaded in this process)")
        return "\n".join(lines)
    lines.append(f"library: {info['path']}")
    lines.append(f"nvcc: {info['seconds']:.2f} s{' (cached build)' if info['cached'] else ''}")
    lines.append(info["log"].rstrip())
    return "\n".join(lines)
