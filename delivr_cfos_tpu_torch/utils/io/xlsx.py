"""Minimal .xlsx writer, without openpyxl (the port's copy of
``delivr_cfos_tpu/utils/io/xlsx.py``).

The reference aggregates per-region counts into ``region_overview.xlsx`` /
``region_collapsed_overview.xlsx`` via ``DataFrame.to_excel``
(reference: cells_to_atlas.py:328-343). This writes the same artifact as a
standards-compliant SpreadsheetML zip with inline strings — readable by
Excel, LibreOffice, and ``pandas.read_excel``.
"""

from __future__ import annotations

import re
import zipfile
from xml.sax.saxutils import escape

import numpy as np

_CONTENT_TYPES = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">
<Default Extension="rels" ContentType="application/vnd.openxmlformats-package.relationships+xml"/>
<Default Extension="xml" ContentType="application/xml"/>
<Override PartName="/xl/workbook.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>
{sheet_overrides}
</Types>"""

_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/officeDocument" Target="xl/workbook.xml"/>
</Relationships>"""

_WORKBOOK = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<workbook xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main" xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships">
<sheets>{sheets}</sheets>
</workbook>"""

_WORKBOOK_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
{rels}
</Relationships>"""


def _col_name(idx: int) -> str:
    """0-based column index → spreadsheet column letters (0 → 'A')."""
    name = ""
    idx += 1
    while idx:
        idx, rem = divmod(idx - 1, 26)
        name = chr(ord("A") + rem) + name
    return name


def _cell_xml(ref: str, value) -> str:
    if value is None:
        return ""
    if isinstance(value, (bool, np.bool_)):
        return f'<c r="{ref}" t="b"><v>{int(value)}</v></c>'
    if isinstance(value, (int, np.integer)):
        return f'<c r="{ref}"><v>{int(value)}</v></c>'
    if isinstance(value, (float, np.floating)):
        if np.isnan(value):
            return ""
        return f'<c r="{ref}"><v>{repr(float(value))}</v></c>'
    text = escape(str(value))
    return f'<c r="{ref}" t="inlineStr"><is><t xml:space="preserve">{text}</t></is></c>'


def _sheet_xml(rows) -> str:
    parts = [
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>',
        '<worksheet xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main">',
        "<sheetData>",
    ]
    for r, row in enumerate(rows, start=1):
        cells = "".join(
            _cell_xml(f"{_col_name(c)}{r}", v) for c, v in enumerate(row)
        )
        parts.append(f'<row r="{r}">{cells}</row>')
    parts.append("</sheetData></worksheet>")
    return "".join(parts)


def _safe_sheet_name(name: str, used: set) -> str:
    name = re.sub(r"[\[\]:*?/\\]", "_", str(name))[:31] or "Sheet"
    base, i = name, 1
    while name in used:
        suffix = f"_{i}"
        name = base[: 31 - len(suffix)] + suffix
        i += 1
    used.add(name)
    return name


def read_xlsx(path: str, sheet: int | str = 0):
    """Minimal xlsx reader → pandas DataFrame (first row = header, first
    column = index, mirroring ``DataFrame.to_excel`` round-trip). Handles
    inline strings (our writer) and sharedStrings (other writers)."""
    import re as _re
    import xml.etree.ElementTree as ET

    import pandas as pd

    ns = {"m": "http://schemas.openxmlformats.org/spreadsheetml/2006/main"}
    with zipfile.ZipFile(path) as z:
        shared = []
        if "xl/sharedStrings.xml" in z.namelist():
            root = ET.fromstring(z.read("xl/sharedStrings.xml"))
            for si in root.findall("m:si", ns):
                shared.append("".join(t.text or "" for t in si.iter() if t.tag.endswith("}t")))
        # resolve sheet index/name via workbook order
        wb = ET.fromstring(z.read("xl/workbook.xml"))
        sheet_names = [s.get("name") for s in wb.iter() if s.tag.endswith("}sheet")]
        if isinstance(sheet, str):
            idx = sheet_names.index(sheet)
        else:
            idx = sheet
        root = ET.fromstring(z.read(f"xl/worksheets/sheet{idx + 1}.xml"))
        rows = []
        for row in root.iter("{http://schemas.openxmlformats.org/spreadsheetml/2006/main}row"):
            cells = {}
            for c in row:
                ref = c.get("r")
                col = _re.match(r"([A-Z]+)", ref).group(1)
                col_idx = 0
                for ch in col:
                    col_idx = col_idx * 26 + (ord(ch) - ord("A") + 1)
                col_idx -= 1
                t = c.get("t")
                if t == "inlineStr":
                    txt = "".join(
                        el.text or "" for el in c.iter() if el.tag.endswith("}t")
                    )
                    cells[col_idx] = txt
                else:
                    v = c.find("m:v", ns)
                    if v is None:
                        continue
                    if t == "s":
                        cells[col_idx] = shared[int(v.text)]
                    elif t == "b":
                        cells[col_idx] = bool(int(v.text))
                    else:
                        val = float(v.text)
                        cells[col_idx] = int(val) if val.is_integer() else val
            rows.append(cells)
    if not rows:
        return pd.DataFrame()
    n_cols = max(max(r.keys(), default=-1) for r in rows) + 1
    grid = [[r.get(i) for i in range(n_cols)] for r in rows]
    header = grid[0]
    df = pd.DataFrame(grid[1:], columns=header)
    first = header[0]
    if first is None:
        df = df.set_index(df.columns[0])
        df.index.name = None
    return df


def write_xlsx(path: str, sheets: dict) -> None:
    """Write ``{sheet_name: rows-or-DataFrame}`` to ``path``.

    A value may be a pandas DataFrame (written like ``DataFrame.to_excel``:
    header row of column names with a leading blank for the index, then one
    row per record with the index value first) or an iterable of rows.
    """
    rendered: list[tuple[str, str]] = []
    used: set = set()
    for name, data in sheets.items():
        name = _safe_sheet_name(name, used)
        if hasattr(data, "itertuples") and hasattr(data, "columns"):  # DataFrame
            rows = [[None] + [str(c) for c in data.columns]]
            for tup in data.itertuples(index=True):
                rows.append(list(tup))
        else:
            rows = [list(r) for r in data]
        rendered.append((name, _sheet_xml(rows)))

    sheet_entries = "".join(
        f'<sheet name="{escape(name)}" sheetId="{i+1}" r:id="rId{i+1}"/>'
        for i, (name, _) in enumerate(rendered)
    )
    rel_entries = "\n".join(
        f'<Relationship Id="rId{i+1}" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/worksheet" Target="worksheets/sheet{i+1}.xml"/>'
        for i in range(len(rendered))
    )
    overrides = "\n".join(
        f'<Override PartName="/xl/worksheets/sheet{i+1}.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.worksheet+xml"/>'
        for i in range(len(rendered))
    )
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("[Content_Types].xml", _CONTENT_TYPES.format(sheet_overrides=overrides))
        z.writestr("_rels/.rels", _RELS)
        z.writestr("xl/workbook.xml", _WORKBOOK.format(sheets=sheet_entries))
        z.writestr("xl/_rels/workbook.xml.rels", _WORKBOOK_RELS.format(rels=rel_entries))
        for i, (_, xml) in enumerate(rendered):
            z.writestr(f"xl/worksheets/sheet{i+1}.xml", xml)
