"""Analysis (port of ``repro.analysis``): the card's roofline peaks
(``roofline``), the control-plane model checker (``mc``) and the
launch-contract lint of the H100 kernels (``lint``). The JAX package's
HLO cost analysis is XLA's; its counterpart is A15's dry run (ROADMAP)."""
