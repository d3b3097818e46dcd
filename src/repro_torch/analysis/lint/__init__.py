"""Static analysis of the port's kernel layer (the counterpart of
``repro.analysis.lint``).

* **Contracts** (`checks`, `driver`): every CUDA launch entry of
  ``src/repro_torch/kernels`` declares a
  :class:`~repro_torch.kernels.contracts.LaunchContract` built by the same
  rules as its C plan function. The checker interprets the tile index maps
  over the block coordinates (symbolically, via `affine`) and, for every
  schedule of the tuner's space at the driver's probe problems, proves
  coverage, race freedom, the split reductions' workspace, shared memory
  and occupancy, precision and the kernels' own limits. On the card,
  `card` holds each verdict and each plan's geometry to the C plan
  function's, and launches every admitted plan.
* **Source** (`source`): AST rules over the kernel wrappers.
* **Trace time** (`jit_audit`): the serving engine's step buckets.

Findings are structured (`findings.Finding`), suppressible by a baseline
file the CLI only reads (the policy: an empty one), and gate through
``python -m repro_torch.analysis.lint``.
"""

from repro_torch.analysis.lint.findings import (          # noqa: F401
    Finding, apply_baseline, load_baseline)
from repro_torch.analysis.lint.driver import (            # noqa: F401
    lint_repo, lint_repo_timed, run_contract_checks, run_source_checks)
