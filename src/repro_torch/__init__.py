"""PyTorch/CUDA port of the ``repro`` package (NVIDIA Hopper target).

Mirrors ``repro``'s sub-layout and names so each module's counterpart is
easy to find.  It imports ``torch`` and never ``jax`` or ``repro``: what it
needs from the reference it keeps as its own copy.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"`` (see ``device.py``).

Ported so far (the serving main path with continuous batching, the dense
and MoE families, kernel calibration and the block autotuner, training):
  configs/           every architecture config (the model runs the dense and
                     MoE families)
  models/            config, layers, transformer, moe, model (with the loss)
  dist/sharding.py   ``Decl`` + seeded init
  kernels/           flash attention (prefill and decode), fused add+RMSNorm,
                     RMSNorm, the SSD scan, add, and the backward of flash
                     attention and of the fused add+RMSNorm (CUDA C++ in
                     csrc/); chip identity, kernel timing and the block
                     autotuner with its on-disk cache (autotune.py)
  train/             synthetic data, AdamW, the microbatched train step
  core/profiler/     accelerator catalog (+ "H100"), kernel cost tables, the
                     analytic profile, kernel calibration
  core/simulator/    network.py (collective time models)
  bench/             fused-vs-unfused and cost-table accuracy benchmarks
  bridge.py          numpy <-> torch params and AdamW state, keyed like the
                     reference's checkpoints
  serve/             kv_cache, paged_cache (``PagedKVAllocator``), serve_step
                     (``BatchedServer``, the decode step as CUDA graphs:
                     ``GraphedDecodeStep``), scheduler
                     (``ContinuousBatchingServer``)
  launch/serve.py    serving CLI (static or ``--continuous``)
  graphs.py          what the CUDA-graphed steps (train, served decode) share
"""
