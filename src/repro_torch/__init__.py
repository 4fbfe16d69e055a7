"""PyTorch/CUDA port of the ``repro`` package (NVIDIA Hopper target).

Mirrors ``repro``'s sub-layout and names so each module's counterpart is
easy to find.  It imports ``torch`` and never ``jax`` or ``repro``: what it
needs from the reference it keeps as its own copy.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"`` (see ``device.py``).

Ported so far (the serving main path, dense family):
  configs/           dense architecture configs
  models/            config, layers, transformer, model
  dist/sharding.py   ``Decl`` + seeded init
  kernels/           flash attention + fused add+RMSNorm (CUDA C++ in csrc/)
  bridge.py          numpy <-> torch params, keyed like the reference's checkpoints
  serve/             kv_cache, serve_step (``BatchedServer``)
  launch/serve.py    serving CLI
"""
