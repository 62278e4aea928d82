"""Static analysis of the port's traced programs.

``repro_torch.analysis.lint`` machine-checks the structural contracts the
port's performance claims rest on, over ATen graphs traced with
``make_fx`` on fake tensors (the reference walks jaxprs):

* **width** — the deployable round body and the zoo round body aggregate
  at cohort width: no floating intermediate scales as O(N*D)
  (``audit_width``; ``audit_replicated_clients`` with a sharded sampler);
* **scan-safety** — every registry ``Sampler``'s carried methods trace
  without a host sync or a data-dependent shape, and ``update`` keeps its
  state's leaves (``audit_scan_safety``);
* **dtype** — no float64 but the sites the port takes by design
  (``audit_dtypes``, ``F64_SITES``);
* **compile-once** — the segment runner is built once a run and its carry
  survives a checkpoint's numpy round trip unchanged
  (``audit_compile_once``).

``run_suite(spec)`` lints one spec, ``sweep_registry()`` the registry;
``python -m repro_torch.analysis.lint`` is the CLI.

The cost model: ``repro_torch.analysis.cost.count`` counts one step's
eager ops on ``meta`` tensors (operations, bytes, memory; kernels 6-8 charged
as their kernels), where the reference walks XLA's HLO (``analysis/hlo.py``
has no counterpart); ``roofline`` projects a count on one H100's datasheet
peaks (``HW``); ``report`` prints the dry run's tables
(``launch.dryrun``).  The lint's and the count's names are loaded lazily,
so importing this package loads no tracing machinery.
"""
from repro_torch.analysis.roofline import HW, RooflineTerms, model_flops, roofline

_LINT_EXPORTS = (
    "Finding",
    "LintReport",
    "audit_width",
    "audit_replicated_clients",
    "audit_scan_safety",
    "audit_dtypes",
    "audit_compile_once",
    "run_suite",
    "sweep_registry",
)

__all__ = ["HW", "RooflineTerms", "roofline", "model_flops", "count", "lint", *_LINT_EXPORTS]


def __getattr__(name):
    if name in _LINT_EXPORTS or name == "lint":
        import repro_torch.analysis.lint as _lint

        return _lint if name == "lint" else getattr(_lint, name)
    if name == "count":
        from repro_torch.analysis.cost import count

        return count
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
