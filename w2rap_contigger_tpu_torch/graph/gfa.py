"""GFA1 dump — reference: GFADump (src/GFADump.cc:8,160-289).

The reference writes two files: <prefix>_lines.gfa (per-line coloring:
one colour per line, S records emitted as lines are walked, L links
within bubble paths and across segment boundaries — GFADump.cc:160-226)
and <prefix>_raw.gfa (canonical edges as S records, links gathered from
both orientations — GFADump.cc:228-285).
"""

from __future__ import annotations

import numpy as np

from ..core.dna import codes_to_seq

# colour cycle for per-line colouring (the reference cycles the CSS
# colour-name list, GFADump.cc:11-14; the cycle identity is what matters)
COLOUR_NAMES = [
    "aliceblue", "antiquewhite", "aqua", "aquamarine", "azure", "beige",
    "bisque", "blanchedalmond", "blue", "blueviolet", "brown", "burlywood",
    "cadetblue", "chartreuse", "chocolate", "coral", "cornflowerblue",
    "cornsilk", "crimson", "cyan", "darkblue", "darkcyan", "darkgoldenrod",
    "darkgray", "darkgreen", "darkkhaki", "darkmagenta", "darkolivegreen",
    "darkorange", "darkorchid", "darkred", "darksalmon", "darkseagreen",
    "darkslateblue", "darkslategray", "darkturquoise", "darkviolet",
    "deeppink", "deepskyblue", "dimgray", "dodgerblue", "firebrick",
    "forestgreen", "fuchsia", "gainsboro", "gold", "goldenrod", "gray",
    "green", "greenyellow", "hotpink", "indianred", "indigo", "khaki",
    "lavender", "lawngreen", "lightblue", "lightcoral", "lightgreen",
    "lightpink", "lightsalmon", "lightseagreen", "lightskyblue", "lime",
    "limegreen", "magenta", "maroon", "mediumaquamarine", "mediumblue",
    "mediumorchid", "mediumpurple", "mediumseagreen", "mediumslateblue",
    "mediumspringgreen", "mediumturquoise", "mediumvioletred",
    "midnightblue", "navy", "olive", "olivedrab", "orange", "orangered",
    "orchid", "peru", "plum", "powderblue", "purple", "red", "rosybrown",
    "royalblue", "saddlebrown", "salmon", "sandybrown", "seagreen",
    "sienna", "silver", "skyblue", "slateblue", "springgreen", "steelblue",
    "tan", "teal", "thistle", "tomato", "turquoise", "violet", "wheat",
    "yellow", "yellowgreen",
]


def gfa_dump_lines(hbv, lines, path_prefix: str, write_seq: bool = True):
    """Write <path_prefix>_lines.gfa: walk each line's cells/paths, emit
    each canonical edge once (CL:z colour = the line's colour), link
    consecutive path edges and connect each path's first edge to the
    previous segment's end edges; gap cells inherit the previous
    segment's ends (GFADump.cc:160-226). Returns the per-edge colour
    map used by the raw dump."""
    E = hbv.n_edges
    inv = hbv.inv
    canon = np.minimum(np.arange(E), inv)
    colour = np.zeros(E, dtype=np.int64)
    included = np.full(E, -1, dtype=np.int64)
    with open(path_prefix + "_lines.gfa", "w") as f:
        f.write("H\tVN:Z:1.0\n")
        cur = 1
        for line in lines:
            prev_ends: list[tuple[int, bool]] = []
            for cell in line:
                ends: list[tuple[int, bool]] = []
                for path in cell:
                    if len(path) == 0:  # gap cell: keep connectivity
                        ends = prev_ends
                        continue
                    prev_e, prev_fw = -1, True
                    for e in path:
                        e = int(e)
                        if included[e] == -1:
                            ce = int(canon[e])
                            included[e] = ce
                            included[inv[e]] = ce
                            name = COLOUR_NAMES[cur % len(COLOUR_NAMES)]
                            seq = (codes_to_seq(hbv.edge_seq(ce))
                                   if write_seq else "*")
                            f.write(f"S\tedge{ce}\t{seq}\tCL:z:{name}\n")
                            colour[ce] = cur
                            colour[inv[ce]] = cur
                        ce = int(included[e])
                        if prev_e != -1:
                            f.write(f"L\tedge{prev_e}\t"
                                    f"{'+' if prev_fw else '-'}\t"
                                    f"edge{ce}\t{'+' if ce == e else '-'}"
                                    f"\t0M\n")
                        prev_e, prev_fw = ce, (ce == e)
                    ce0 = int(included[int(path[0])])
                    fw0 = ce0 == int(path[0])
                    for pe, pfw in prev_ends:
                        f.write(f"L\tedge{pe}\t{'+' if pfw else '-'}\t"
                                f"edge{ce0}\t{'+' if fw0 else '-'}\t0M\n")
                    ends.append((prev_e, prev_fw))
                prev_ends = ends
            cur += 1
    return colour


def gfa_dump(hbv, path_prefix: str, write_seq: bool = True,
             find_lines: bool = False, lines=None):
    """Write <path_prefix>_raw.gfa: S per canonical edge pair (the lower
    id of (e, inv[e])), L links with orientations, K-1 overlap. With
    find_lines=True also writes <path_prefix>_lines.gfa and colours the
    raw S records by line (GFADump.cc:156-235; uncoloured edges are
    "black")."""
    E = hbv.n_edges
    inv = hbv.inv
    canon = np.minimum(np.arange(E), inv)
    k = hbv.k
    colour = None
    if find_lines or lines is not None:
        if lines is None:
            from .lines import find_lines as _find_lines, sort_lines

            lines = sort_lines(hbv, _find_lines(hbv))
        colour = gfa_dump_lines(hbv, lines, path_prefix, write_seq)
    with open(path_prefix + "_raw.gfa", "w") as f:
        f.write("H\tVN:Z:1.0\n")
        for e in range(E):
            if canon[e] != e:
                continue
            seq = codes_to_seq(hbv.edge_seq(e)) if write_seq else "*"
            cl = ""
            if colour is not None:
                name = (COLOUR_NAMES[colour[e] % len(COLOUR_NAMES)]
                        if colour[e] > 0 else "black")
                cl = f"\tCL:z:{name}"
            f.write(f"S\t{e}\t{seq}\tLN:i:{hbv.edge_len(e)}{cl}\n")
        links = set()
        fo, fe, to, te = hbv.vertex_csr()
        for e1 in range(E):
            v = hbv.to_right[e1]
            outs = fe[fo[v] : fo[v + 1]]
            c1 = int(canon[e1])
            o1 = "+" if c1 == e1 else "-"
            for e2 in outs:
                c2 = int(canon[e2])
                o2 = "+" if c2 == e2 else "-"
                key = (c1, o1, c2, o2)
                # dedupe against the rc-mirrored link
                mkey = (
                    c2,
                    "+" if o2 == "-" else "-",
                    c1,
                    "+" if o1 == "-" else "-",
                )
                if mkey in links:
                    continue
                links.add(key)
        for c1, o1, c2, o2 in sorted(links):
            f.write(f"L\t{c1}\t{o1}\t{c2}\t{o2}\t{k-1}M\n")
