"""Engine utilities: unique display filenames.

Host copy of ``thesia_tpu/engine/utils.py`` (verbatim); the port imports
nothing of the JAX package.  Pinned by ``tests/test_torch_session.py``.

reference: src-tauri/src/core/utils.rs:11-59 — when several tracks share a
filename, disambiguate by walking up parent directories until unique, joining
with the path separator; fully-exhausted paths canonicalize.
"""

from __future__ import annotations

import os
from pathlib import Path


def unique_filenames(paths: dict[int, str]) -> dict[int, str]:
    result: dict[int, str] = {}
    groups: dict[str, dict[int, Path]] = {}
    for track_id, p in paths.items():
        path = Path(p)
        name = path.name
        if not name:
            result[track_id] = str(path)
            continue
        groups.setdefault(name, {})[track_id] = path.parent
    for name, members in groups.items():
        if len(members) == 1:
            (track_id,) = members
            result[track_id] = name
        else:
            parents = unique_filenames({i: str(p) for i, p in members.items()})
            for track_id, parent in parents.items():
                if Path(parent).parent == Path(parent):  # hit filesystem root
                    joined = f"{parent}{name}"
                    try:
                        joined = str(Path(joined).resolve())
                    except OSError:
                        pass
                    result[track_id] = joined
                else:
                    result[track_id] = f"{parent}{os.sep}{name}"
    return result
