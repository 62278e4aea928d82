"""The port's benchmark tables (``benchmarks/run.py``'s counterparts).

``python -m repro_torch.bench.tables`` prints the paper figures' rows
(fig2, fig3b, fig4) from the JSON the port's examples write under
``results/torch/``; ``python -m repro_torch.bench.host_ab OTHER`` times
kernels 6-8's wrappers on the host against another checkout's.  The rest of ``benchmarks/run.py`` is still to port
(``ROADMAP.md`` §1 item 7).
"""
