"""Minimal xlsx IO on the standard library (zipfile + ElementTree): a copy
of ``open_o3_video_tpu/utils/xlsx.py``, held equal to it in the tests.

The reference's WorldSense harness dumps prediction/score tables as .xlsx
via pandas+xlsxwriter (eval/dataloader/worldsense.py:403-460, 523-563).
pandas has no xlsx engine without xlsxwriter or openpyxl, so this module
implements the tiny subset needed for that contract: one sheet, header row,
str/num cells. Files written here open in Excel/pandas; files written by
pandas+xlsxwriter/openpyxl (shared-strings or inline) read back here.
"""

from __future__ import annotations

import re
import zipfile
import xml.etree.ElementTree as ET
from typing import Any

_NS = "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}"

_CONTENT_TYPES = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">
<Default Extension="rels" ContentType="application/vnd.openxmlformats-package.relationships+xml"/>
<Default Extension="xml" ContentType="application/xml"/>
<Override PartName="/xl/workbook.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>
<Override PartName="/xl/worksheets/sheet1.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.worksheet+xml"/>
</Types>"""

_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/officeDocument" Target="xl/workbook.xml"/>
</Relationships>"""

_WORKBOOK = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<workbook xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main" xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships">
<sheets><sheet name="Sheet1" sheetId="1" r:id="rId1"/></sheets>
</workbook>"""

_WORKBOOK_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/worksheet" Target="worksheets/sheet1.xml"/>
</Relationships>"""


def _col_name(i: int) -> str:
    """0 -> A, 25 -> Z, 26 -> AA ..."""
    name = ""
    i += 1
    while i:
        i, rem = divmod(i - 1, 26)
        name = chr(65 + rem) + name
    return name


def _esc(s: str) -> str:
    return (s.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;")
            .replace('"', "&quot;"))


def _cell_xml(ref: str, value: Any) -> str:
    if value is None:
        return ""
    if isinstance(value, bool):
        return f'<c r="{ref}" t="b"><v>{int(value)}</v></c>'
    if isinstance(value, (int, float)):
        if value != value:  # NaN -> empty cell (pandas NaN round-trip)
            return ""
        return f'<c r="{ref}"><v>{value!r}</v></c>'
    s = _esc(str(value))
    # strip control chars xlsx forbids
    s = re.sub(r"[\x00-\x08\x0b\x0c\x0e-\x1f]", "", s)
    return f'<c r="{ref}" t="inlineStr"><is><t xml:space="preserve">{s}</t></is></c>'


def write_xlsx(path: str, rows: list[dict[str, Any]], columns=None) -> None:
    """Write a single-sheet xlsx from a list of dict rows (or a DataFrame
    via ``df.to_dict("records")`` + ``columns=list(df.columns)``)."""
    if columns is None:
        columns = []
        for r in rows:
            for k in r:
                if k not in columns:
                    columns.append(k)
    body = ["<row r=\"1\">" + "".join(
        _cell_xml(f"{_col_name(c)}1", col) for c, col in enumerate(columns)
    ) + "</row>"]
    for i, row in enumerate(rows):
        ref = i + 2
        body.append(f'<row r="{ref}">' + "".join(
            _cell_xml(f"{_col_name(c)}{ref}", row.get(col))
            for c, col in enumerate(columns)
        ) + "</row>")
    sheet = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<worksheet xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main">'
        "<sheetData>" + "".join(body) + "</sheetData></worksheet>"
    )
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("[Content_Types].xml", _CONTENT_TYPES)
        z.writestr("_rels/.rels", _RELS)
        z.writestr("xl/workbook.xml", _WORKBOOK)
        z.writestr("xl/_rels/workbook.xml.rels", _WORKBOOK_RELS)
        z.writestr("xl/worksheets/sheet1.xml", sheet)


def _cell_col(ref: str) -> int:
    col = 0
    for ch in ref:
        if ch.isalpha():
            col = col * 26 + (ord(ch.upper()) - 64)
        else:
            break
    return col - 1


def read_xlsx(path: str) -> list[dict[str, Any]]:
    """Read sheet 1 of an xlsx into list-of-dict rows (header row = keys).
    Handles inline strings, shared strings, numbers and booleans."""
    with zipfile.ZipFile(path) as z:
        shared: list[str] = []
        if "xl/sharedStrings.xml" in z.namelist():
            root = ET.fromstring(z.read("xl/sharedStrings.xml"))
            for si in root.findall(f"{_NS}si"):
                shared.append("".join(t.text or "" for t in si.iter(f"{_NS}t")))
        sheet_names = [n for n in z.namelist()
                       if re.fullmatch(r"xl/worksheets/sheet\d+\.xml", n)]
        root = ET.fromstring(z.read(sorted(sheet_names)[0]))

    grid: list[dict[int, Any]] = []
    for row in root.iter(f"{_NS}row"):
        cells: dict[int, Any] = {}
        for c in row.findall(f"{_NS}c"):
            col = _cell_col(c.get("r", ""))
            t = c.get("t", "n")
            if t == "inlineStr":
                is_el = c.find(f"{_NS}is")
                val = "".join(x.text or "" for x in is_el.iter(f"{_NS}t")) if is_el is not None else ""
            else:
                v = c.find(f"{_NS}v")
                if v is None or v.text is None:
                    continue
                if t == "s":
                    val = shared[int(v.text)]
                elif t == "b":
                    val = bool(int(v.text))
                elif t == "str":
                    val = v.text
                else:
                    f = float(v.text)
                    val = int(f) if f.is_integer() else f
            cells[col] = val
        grid.append(cells)
    if not grid:
        return []
    header = grid[0]
    cols = {c: str(header.get(c, f"col{c}")) for c in sorted(header)}
    return [
        {name: cells.get(c) for c, name in cols.items()}
        for cells in grid[1:]
    ]
