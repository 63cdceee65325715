"""moonrtx_tpu_torch — the PyTorch/CUDA port of moonrtx_tpu for NVIDIA Hopper.

A second package beside the JAX reference (``moonrtx_tpu``), ported slice
by slice. It imports torch and numpy, never jax and never any module of
``moonrtx_tpu``: the numpy-only host modules (constants, types, config,
orientation, astro/, data/, app/codec, engine/light) are copies with their
imports renamed.

It carries the headless render path: ``app.headless.build_scene`` ->
``MoonScene.update_view`` -> ``MoonScene.render`` (shadow scan plus the
one-bounce pyramid, per-block windows, accumulation) -> ``display``,
through the three backends of the reference: the windowed "blocked"
backend (the default), the march-kernel "pallas" backend and the gather
"reference" backend. Its hand-written Hopper kernels live in ``csrc/``;
each wrapper in ``ops/`` is declared beside its plain PyTorch version
(``kernels.register``), and ``kernels.registered()`` lists them.

Entry points run on the card unless the caller passes ``device="cpu"``
(moonrtx_tpu_torch.device). The reference's single-device entry points
are here too: ``python -m moonrtx_tpu_torch`` (app.cli: the headless
still and time-lapse, the Tk window) and the Tk launcher
``python -m moonrtx_tpu_torch.app.launcher``; ``MOONRTX_PLATFORM=cpu``
asks the CLI for the CPU.
"""

__version__ = "0.1.0"

APP_NAME = "MoonRTX-TPU (PyTorch/CUDA)"
