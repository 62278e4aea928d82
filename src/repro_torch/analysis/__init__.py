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
``python -m repro_torch.analysis.lint`` is the CLI.  The reference's cost
models (``analysis/hlo.py``, ``report.py``, ``roofline.py``) read XLA's HLO
and are not here.  The lint names are loaded lazily, so importing this
package loads no tracing machinery.
"""

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

__all__ = ["lint", *_LINT_EXPORTS]


def __getattr__(name):
    if name in _LINT_EXPORTS or name == "lint":
        import repro_torch.analysis.lint as _lint

        return _lint if name == "lint" else getattr(_lint, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
