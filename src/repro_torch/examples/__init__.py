"""The paper's examples on the port, run as modules::

    python -m repro_torch.examples.quickstart        # K-Vib vs uniform ISP
    python -m repro_torch.examples.synthetic_regret  # Fig. 2: regret, variance
    python -m repro_torch.examples.budget_sweep      # Fig. 3b: regret vs K
    python -m repro_torch.examples.femnist_style     # Fig. 4: unbalance levels
    python -m repro_torch.examples.fed_lm            # Fig. 5: federated LMs

Each keeps the reference example's flags, defaults, specs and printed
table (``examples/*.py``), adds ``--device`` (default: the GPU) and writes
its JSON under ``results/torch/``; ``python -m repro_torch.bench.tables``
prints the figures' rows from it.  Each example builds its specs through a
module-level function, so a test can hold them to the reference's.
"""
