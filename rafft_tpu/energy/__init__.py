"""Integer Turner-2004 nearest-neighbour energy model (dekacal/mol).

Replaces the reference's ViennaRNA oracle (`RNA.fold_compound(...).
eval_structure`, /root/reference/rafft/utils.py:7,18-21,135-138) with a
self-contained table-driven evaluator:

  - params.py    — parameter container + temperature rescaling
  - _turner2004.py — raw dG37/dH tables
  - _calibrated.py — exact corrections recovered from the reference's
                     frozen (sequence, structure, energy) corpus
  - eval_np.py   — exact integer CPU evaluator (the oracle)
  - eval_jax.py  — batched JAX evaluator (same integer arithmetic)
"""

from rafft_tpu.energy.params import EnergyParams, get_params
from rafft_tpu.energy.eval_np import eval_structure, eval_structure_int

__all__ = ["EnergyParams", "get_params", "eval_structure", "eval_structure_int"]
