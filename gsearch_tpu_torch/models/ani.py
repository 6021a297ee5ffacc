"""Distance <-> similarity <-> ANI/AAI conversion models.

Exactly the reference's two Mash-style models (reference:
src/bin/reformat.rs:80-85, README.md:110-117; AAI variant
binaux/src/bin/superaai.rs:158-159; bindash distance
src/bin/bindash.rs:93-99):

  J = 1 - distance          (slot-equality fraction -> Jaccard estimate)
  Poisson  (model 1): ANI = 1 + ln(2J / (1+J)) / k
  Binomial (model 2): ANI = (2J / (1+J))^(1/k)

and the inverse used by the all-pairs comparators:
  distance = 1 - (2s / (1+s))^(1/k)
"""

from __future__ import annotations

import numpy as np


def ani_from_distance(distance, k: int, model: int = 1):
    """distance (1 - Jaccard) -> ANI in [0, 100]."""
    d = np.asarray(distance, dtype=np.float64)
    j = 1.0 - d
    core = 2.0 * j / (1.0 + j)
    with np.errstate(divide="ignore", invalid="ignore"):
        if model == 1:
            ani = (1.0 + np.log(core) / k) * 100.0
        elif model == 2:
            ani = np.power(core, 1.0 / k) * 100.0
        else:
            raise ValueError("model must be 1 (Poisson) or 2 (Binomial)")
    return ani


def distance_from_similarity(similarity, k: int):
    """Mash-style distance from a Jaccard-like similarity
    (reference: src/bin/bindash.rs:93-99, src/bin/hypermash.rs:258-266)."""
    s = np.asarray(similarity, dtype=np.float64)
    core = 2.0 * s / (1.0 + s)
    return 1.0 - np.power(core, 1.0 / np.asarray(k, dtype=np.float64))
