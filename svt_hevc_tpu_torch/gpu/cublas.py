"""cuBLAS workspace clears shared by the port's CUDA-graph captures (the
intra wavefront's step graphs, gpu/intra_pass.py, and the fused P
chain's replay scripts, gpu/chain_script.py).

cuBLAS keeps a workspace per stream (32 MiB on Hopper), allocated on the
stream's first matmul; the private torch._C._cuda_clearCublasWorkspaces()
frees the workspaces of every stream in the process. A capture clears
them on entry, so the capture stream's workspace is allocated inside the
capture, in the graph's pool, and on exit, so it is not counted as
allocated while the graph is kept. A clear from another thread inside a
capture would free that workspace while the capture may still allocate
from the pool: every clear takes CUBLAS_LOCK, and a P-chain recording
holds it throughout.
"""

import threading

import torch

CUBLAS_LOCK = threading.RLock()


def clear_cublas_workspaces() -> None:
    with CUBLAS_LOCK:
        torch._C._cuda_clearCublasWorkspaces()
