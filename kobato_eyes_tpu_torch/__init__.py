"""kobato-eyes on PyTorch and CUDA: the port of ``kobato_eyes_tpu``.

The JAX package beside it stays the reference; every module here is held
against its counterpart there on the same inputs (``tests/test_torch_*.py``).
Module names mirror the JAX package's. Host-only modules are copies; device
code is PyTorch tensor code, and each Pallas kernel of the JAX package on a
ported path becomes a CUDA kernel written for Hopper (``csrc/``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``device.resolve_device``). Nothing here imports JAX.

Layering (low to high; enforced by tests/test_torch_imports.py):

    utils    -> stdlib/PIL/numpy helpers
    native   -> host C++ (band scan, cluster assembly), built with g++ at first use
    device   -> device selection
    ops      -> hand-written CUDA kernels with their plain torch versions,
                and the device passes of hashing and the banded scan
    parallel -> device meshes, sharding rules, the sharded dup scan,
                multi-host initialization
    db       -> host durability catalog (SQLite)
    models   -> ViT / SwinV2 taggers (nn.Module), pre/postprocess
    sig      -> pHash/dHash signatures: host decode + batched device pass
    dup      -> duplicate clusters: scan engine, refinement, cohesion audit
    query    -> tag query language: AST, SQL backend
    services -> async write-back services
    core     -> config, scanner, pipeline stages
    cli      -> the command surface
"""

__version__ = "0.1.0"
