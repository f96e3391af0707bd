"""Raw data I/O: a copy of ``recommendation_tpu/data/io.py``.

Behavior contract: whitespace-split lines of ``user item [rating]``; first
two columns used, weight defaults to 1.0; blank lines skipped; a missing
file returns ``[]``. ``load_data`` is the Python path always; the native
parser's gain is ``Interaction.from_files``, which keeps its output as
arrays.
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
    """Parse ``user item [rating]`` triples; missing file -> [].

    Always the Python path: for a list-of-lists result, Python list
    construction dominates and the native parser gains nothing. The native
    win is ``Interaction.from_files``, which keeps the parse output as
    int32/float32 arrays end to end."""
    if not os.path.exists(path):
        return []
    return _load_data_python(path, with_weight)


class FileIO:
    """File helpers matching `selfcf.py:69-91` semantics."""

    @staticmethod
    def load_data_set(path: str) -> List[list]:
        return load_data(path)

    @staticmethod
    def write_file(dir_path: str, filename: str, content) -> None:
        os.makedirs(dir_path, exist_ok=True)
        with open(os.path.join(dir_path, filename), "w") as f:
            if isinstance(content, str):
                f.write(content)
            else:
                f.writelines(content)
