"""HIBF layout tree + chopper "pack file" text format.

The reference consumes a layout text file produced by chopper
(read at src/hixf/build/read_chopper_pack_file.cpp, grammar in
parse_chopper_pack_header.cpp / parse_chopper_pack_line.cpp):

    #HIGH_LEVEL_IBF max_bin_id:<B>
    #MERGED_BIN_<a>[;<b>...] max_bin_id:<B>
    #FILES\tBIN_INDICES\tNUMBER_OF_BINS
    <f1>[;<f2>...]\t<a>[;<b>...]\t<s0>[;<s1>...]

We keep the same text format as the build-stage interchange artifact
("binning.out", taxor_build.cpp:488-500) and parse it into a tree.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class LayoutRecord:
    """One user bin placement: leaf (possibly split across
    ``number_of_bins`` technical bins) at ``bin_index`` of its node."""

    filenames: list[str]
    bin_index: int
    number_of_bins: int


@dataclass
class LayoutNode:
    """One IXF of the hierarchy."""

    max_bin_index: int = 0
    num_technical_bins: int = 0
    children: dict[int, "LayoutNode"] = field(default_factory=dict)
    records: list[LayoutRecord] = field(default_factory=list)

    def all_filenames(self) -> list[str]:
        out: list[str] = []
        for rec in self.records:
            out.extend(rec.filenames)
        for child in self.children.values():
            out.extend(child.all_filenames())
        return out


def flat_layout(filenames: list[str]) -> LayoutNode:
    """Trivial layout: one root IXF, one technical bin per user bin."""
    root = LayoutNode(max_bin_index=0, num_technical_bins=len(filenames))
    for i, f in enumerate(filenames):
        root.records.append(LayoutRecord([f], i, 1))
    return root


def write_layout(node: LayoutNode, path: str) -> None:
    lines: list[str] = []
    header: list[str] = [f"#HIGH_LEVEL_IBF max_bin_id:{node.max_bin_index}"]

    def emit(n: LayoutNode, prefix: list[int]):
        for b in sorted(n.children):
            child = n.children[b]
            idx = ";".join(str(x) for x in prefix + [b])
            header.append(f"#MERGED_BIN_{idx} max_bin_id:{child.max_bin_index}")
        for rec in n.records:
            files = ";".join(rec.filenames)
            idx = ";".join(str(x) for x in prefix + [rec.bin_index])
            nb = ";".join(
                ["1"] * len(prefix) + [str(rec.number_of_bins)]
            )
            lines.append(f"{files}\t{idx}\t{nb}")
        for b in sorted(n.children):
            emit(n.children[b], prefix + [b])

    emit(node, [])
    with open(path, "w") as fh:
        fh.write("\n".join(header) + "\n")
        fh.write("#FILES\tBIN_INDICES\tNUMBER_OF_BINS\n")
        fh.write("\n".join(lines) + ("\n" if lines else ""))


def parse_layout(path: str) -> LayoutNode:
    root = LayoutNode()
    with open(path) as fh:
        raw = [line.rstrip("\n") for line in fh if line.strip()]
    body_start = 0
    merged_headers: list[tuple[list[int], int]] = []
    for i, line in enumerate(raw):
        if line.startswith("##"):
            continue  # config header lines are skipped, like the reference
        if line.startswith("#HIGH_LEVEL_IBF"):
            root.max_bin_index = int(line.split("max_bin_id:")[1])
        elif line.startswith("#MERGED_BIN_"):
            spec = line[len("#MERGED_BIN_") :]
            idx_str, max_str = spec.split(" max_bin_id:")
            merged_headers.append(
                ([int(x) for x in idx_str.split(";")], int(max_str))
            )
        elif line.startswith("#FILES"):
            body_start = i + 1
            break
    # shallow nodes first, as the reference sorts them
    # (parse_chopper_pack_header.cpp:87-92)
    merged_headers.sort(key=lambda r: len(r[0]))
    for indices, max_id in merged_headers:
        node = root
        for b in indices[:-1]:
            node = node.children[b]
        node.children[indices[-1]] = LayoutNode(max_bin_index=max_id)

    for line in raw[body_start:]:
        files_str, idx_str, nb_str = line.split("\t")
        indices = [int(x) for x in idx_str.split(";")]
        nbins = [int(x) for x in nb_str.split(";")]
        node = root
        for b, n in zip(indices[:-1], nbins[:-1]):
            node.num_technical_bins = max(node.num_technical_bins, b + n)
            node = node.children[b]
        node.num_technical_bins = max(
            node.num_technical_bins, indices[-1] + nbins[-1]
        )
        rec = LayoutRecord(files_str.split(";"), indices[-1], nbins[-1])
        # the max-bin record goes first (read_chopper_pack_file.cpp:78-81)
        if rec.bin_index == node.max_bin_index:
            node.records.insert(0, rec)
        else:
            node.records.append(rec)
    return root
