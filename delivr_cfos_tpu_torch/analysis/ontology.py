"""Allen CCFv3 ontology XML → DataFrame (reference: cells_to_atlas.py:26-90);
the port's copy of ``delivr_cfos_tpu/analysis/ontology.py``.

Row 0 is a synthetic background entry; structure rows follow XML document
order, which for the Allen ontology is depth-first = graph_order order. The
annotation volume stores graph_order values (uint16), and lookups use
``iloc[graph_order + 1]`` (the +1 skips the background row; reference
cells_to_atlas.py:211-218).

Quirks reproduced: ``id-original`` preferred over ``id``; remaps
312782566→312782560 and 614454277→614454272 (only the latter exist in the
annotation volume); the root structure's parent_acronym is the literal
string ``"root"`` (with quotes); acronyms have double quotes stripped.
The O(n²) parent scan of the reference is replaced by an id→acronym dict.
"""

from __future__ import annotations

import io
from typing import TYPE_CHECKING
from xml.etree import ElementTree as ET

if TYPE_CHECKING:
    import pandas as pd

COLUMNS = [
    "id",
    "name",
    "acronym",
    "red",
    "green",
    "blue",
    "graph_order",
    "parent_id",
    "parent_acronym",
    "color-hex-triplet",
    "structure-level",
]

_ID_REMAP = {312782566: 312782560, 614454277: 614454272}


def parse_ontology_xml(path: str) -> pd.DataFrame:
    # pandas loads on the first call: the package's __init__ exports this
    # function, and importing it stays free of pandas
    import pandas as pd

    with io.open(path, "r", encoding="utf-8-sig") as f:
        root = ET.fromstring(f.read())

    structures = list(root.iter("structure"))
    acronym_by_id = {
        s.find("id").text: s.find("acronym").text for s in structures
    }

    rows = [(0, "background", "bgr", 0, 0, 0, 0, "None", "None", "000000", 0)]
    for s in structures:
        orig = s.find("id-original")
        structure_id = int((orig if orig is not None else s.find("id")).text)
        structure_id = _ID_REMAP.get(structure_id, structure_id)
        parent_id = s.find("parent-structure-id").text
        parent_acronym = acronym_by_id.get(parent_id, "None")
        if int(s.find("id").text) == 997:
            parent_acronym = '"root"'  # reference: cells_to_atlas.py:60-62
        hex_triplet = s.find("color-hex-triplet").text
        r, g, b = (int(hex_triplet[i : i + 2], 16) for i in (0, 2, 4))
        rows.append(
            (
                structure_id,
                s.find("name").text,
                s.find("acronym").text.replace('"', ""),
                r,
                g,
                b,
                int(s.find("graph-order").text),
                parent_id,
                parent_acronym,
                hex_triplet,
                int(s.find("st-level").text),
            )
        )
    return pd.DataFrame.from_records(rows, columns=COLUMNS)
