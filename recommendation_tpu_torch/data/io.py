"""Raw data I/O: a copy of ``recommendation_tpu/data/io.py``'s Python path.

Behavior contract: whitespace-split lines of ``user item [rating]``; first
two columns used, weight defaults to 1.0; blank lines skipped; a missing
file returns ``[]``.
"""

from __future__ import annotations

import os
from typing import List


def _load_data_python(path: str, with_weight: bool = True) -> List[list]:
    data = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            user, item = parts[0], parts[1]
            if with_weight and len(parts) >= 3:
                try:
                    weight = float(parts[2])
                except ValueError:
                    weight = 1.0
            else:
                weight = 1.0
            data.append([user, item, weight])
    return data


def load_data(path: str, with_weight: bool = True) -> List[list]:
    """Parse ``user item [rating]`` triples; missing file -> []."""
    if not os.path.exists(path):
        return []
    return _load_data_python(path, with_weight)
