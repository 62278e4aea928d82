"""PyTorch/CUDA port of ``repro`` (Adaptive Unbiased Client Sampling, K-Vib).

The package mirrors the JAX reference's layout (``data/``, ``fed/``,
``core/``, ``optim/``, ``kernels/``, ``api/``, ``launch/``) so each module's counterpart
is found under the same path.  It imports ``torch`` and numpy only, never
``jax`` or ``repro``.

Entry points take an explicit ``device`` and run on the GPU unless the caller
asks for the CPU (``repro_torch.device.resolve_device``); with no GPU present
they raise instead of falling back::

    from repro_torch import api
    hist = api.run(api.ExperimentSpec.load("experiment.json"))          # GPU
    hist = api.run(api.ExperimentSpec.load("experiment.json"), device="cpu")

Ported so far: the simulation-task federated round (``api.run`` with
``kind="task"``) with the ``kvib`` and ``uniform_isp`` samplers, in oracle
and deployable modes, with plain or compressed (int8 / fp8, error feedback)
client deltas, with or without the fault layer (availability, deadline
stragglers, buffered async) and the sharded K-Vib solve
(``execution.sampler_axis``); ``kernels.ops.aggregate_cohort_updates``; and
the five kernels on those paths.
``ROADMAP.md`` lists what is still to be ported.
"""
