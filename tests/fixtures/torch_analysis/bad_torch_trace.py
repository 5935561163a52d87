"""T1-T4 fixture for the port's hot-loop pass (iotml_torch.analysis
.tracecheck): every function above the marker comment seeds one
hazard kind, every one below it is an idiom that must stay clean.
Parsed only, never imported; a parameter annotated ``torch.Tensor`` is
a device value."""

import ctypes
import functools

import torch

from iotml_torch.ops import _build


def branchy(loss: torch.Tensor, x: torch.Tensor):
    if loss > 0.5:                          # T1: branch on a device value
        x = x * 2
    return x


def syncs(x: torch.Tensor, w: torch.Tensor):
    y = x @ w
    a = y.sum().item()                      # T2
    b = float(y.mean())                     # T2
    c = y.cpu().numpy()                     # T2 (the .cpu(), once)
    torch.cuda.synchronize()                # T2
    return a, b, c


def per_call_build(x: torch.Tensor):
    lib = _build.load("fused_train")        # T3
    eng = ctypes.CDLL("libengine.so")       # T3
    return lib, eng, x


def shapes(x: torch.Tensor, n: torch.Tensor):
    z = torch.zeros(n)                      # T4
    return x.reshape(n, -1), z              # T4


# ---- clean shapes: nothing below this line may be flagged
def clean_static_branches(x: torch.Tensor, mask=None):
    if x.shape[0] == 0 or x.dim() != 2 or mask is None:
        return x
    if any(t.dtype != x.dtype for t in (x, mask)):
        raise ValueError("one dtype")
    return torch.where(x > 0, x, torch.zeros_like(x))


def clean_host_scalars(x: torch.Tensor, epochs: int):
    n = int(epochs)
    b = int(x.shape[0])
    return torch.zeros(n, device=x.device), x.reshape(b, -1)


@functools.lru_cache(maxsize=None)
def _cached_library():
    return ctypes.CDLL("libengine.so")


def make_loader():
    return _build.load("fused_train")


def clean_cached_loader(x: torch.Tensor):
    return _cached_library(), x


def clean_suppressed_sync(x: torch.Tensor):
    # lint-ok: T2 the one read-back this call makes by design
    return x.sum().item()


def clean_after_sync(x: torch.Tensor):
    host = x.sum(dim=0).cpu().numpy()  # lint-ok: T2 the one read-back
    return host.tolist(), float(host[0])
