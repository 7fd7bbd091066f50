"""Phase timing + structured run stats (shim).

The implementation lives in ``obs.timing``, unified with the serve
engines' OpTimer over the obs histogram; this module keeps the JAX
package's import path (``utils/timing.py``) for the same class.
"""

from __future__ import annotations

from ..obs.timing import PhaseTimer

__all__ = ["PhaseTimer"]
