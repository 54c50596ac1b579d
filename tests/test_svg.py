"""Structural SVG-renderer tests (report/svg.py) against independently
recomputed geometry — a renderer regression (indent arithmetic, connector
placement, last-child shortening, dash threshold, longest-path marking,
label format) fails these, unlike the old existence+substring check
(ref geometry: match/TaxTreePainter.java:104-217,
labels :338-364)."""

import re
import xml.etree.ElementTree as ET

import numpy as np
import pytest

from fixtures import make_dengue_world

from genestrip_tpu.maker import GSMaker
from genestrip_tpu.report.reporter import compute_distances
from genestrip_tpu.report.svg import _fmt_d, write_svg_taxtree

NS = {"svg": "http://www.w3.org/2000/svg"}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    project, g1, g2, reads = make_dengue_world(tmp_path_factory.mktemp("svg"))
    maker = GSMaker(project)
    db = maker.goal("updatedb").get()
    return project, db


def _render(project, db, tmp_path, **overrides):
    # defaults mirror the reference (all display toggles false,
    # GSConfigKey.java:279-291); the tests pin the full-feature rendering
    base = {"svgShowRank": "true", "svgShowDistance": "true",
            "svgShowDistancePortion": "true", "svgMarkLongestPath": "true"}
    for k, v in {**base, **overrides}.items():
        project.config.set_override(k, v)
    out = tmp_path / "tree.svg"
    write_svg_taxtree(project, db, out)
    root = ET.fromstring(out.read_text())
    texts = root.findall("svg:text", NS)
    lines = root.findall("svg:line", NS)
    return root, texts, lines


def test_labels_order_and_format(world, tmp_path):
    project, db = world
    _, texts, _ = _render(project, db, tmp_path)
    tree = db.tree
    stats = db.stats()
    dist, portion, _ = compute_distances(tree, stats, db.k)
    assert len(texts) == len(tree)          # one label per node, tree order
    for i, t in enumerate(texts):
        # ref getNodeText:338-364: "name (taxid[, rank]) [kmers,d=..,dp=..]"
        want = f"{tree.names[i]} ({tree.taxids[i]}"
        r = tree.rank_name(i)
        if r:
            want += f", {r}"
        want += f") [{stats.get(tree.taxids[i], 0)}"
        want += f",d={_fmt_d(dist[i])},dp={_fmt_d(portion[i])}]"
        assert t.text == want, f"node {i}"
        # requested nodes bold (ref svgReqNodesBold)
        weight = t.get("font-weight")
        assert weight == ("bold" if tree.requested[i] else "normal")


def test_indent_arithmetic_and_rows(world, tmp_path):
    project, db = world
    p = project
    _, texts, _ = _render(project, db, tmp_path)
    tree = db.tree
    stats = db.stats()
    dist, portion, _ = compute_distances(tree, stats, db.k)
    # independent reimplementation of the running per-level indent model
    # (ref paintTree:104-160): level L's width is the LAST value set by a
    # node at that level; text x = sum(widths[0..L]) + L * std_indent
    font_height = int(round(0.8 * p["svgFontSize"])) + int(
        round(0.25 * p["svgFontSize"]))
    line_h = int(round(p["svgLineHeightFactor"] * font_height))
    std_indent = int(round(p["svgIndentFactor"] * line_h))
    nif = p["svgKmerNodeIndentFactor"]
    widths = {}
    for i, t in enumerate(texts):
        level = int(tree.depth[i])
        d = dist[i]
        if p["svgDistanceIndent"]:
            w = 0 if (d == 1 or d != d) else (
                int(portion[i] * nif) if portion[i] == portion[i] else 0)
        else:
            mx = max((stats.get(tid, 0) for tid in tree.taxids if tid),
                     default=0) or 1
            w = int(stats.get(tree.taxids[i], 0) / mx * nif)
        widths[level] = w
        want_x = sum(widths.get(j, 0) for j in range(level + 1)) \
            + level * std_indent
        assert int(t.get("x")) == want_x, f"node {i}"
        # row placement: text baseline inside row i's band
        y = int(t.get("y"))
        assert i * line_h <= y <= (i + 1) * line_h, f"node {i}"


def test_connectors_and_last_child_shortening(world, tmp_path):
    project, db = world
    p = project
    _, texts, lines = _render(project, db, tmp_path)
    tree = db.tree
    font_height = int(round(0.8 * p["svgFontSize"])) + int(
        round(0.25 * p["svgFontSize"]))
    line_h = int(round(p["svgLineHeightFactor"] * font_height))
    # horizontal connector per non-root node: y1 == y2 == row mid
    horiz = [ln for ln in lines if ln.get("y1") == ln.get("y2")]
    n_nonroot = sum(1 for i in range(len(tree)) if tree.parent[i] >= 0)
    assert len(horiz) == n_nonroot
    mids = sorted(int(ln.get("y1")) for ln in horiz)
    want_mids = sorted(i * line_h + line_h // 2
                       for i in range(len(tree)) if tree.parent[i] >= 0)
    assert mids == want_mids
    # vertical connectors: a last child's own-level segment stops at the
    # row middle (ref :176-183); all verticals span either line_h or
    # line_h - line_h//2
    vert = [ln for ln in lines if ln.get("y1") != ln.get("y2")]
    spans = {int(ln.get("y2")) - int(ln.get("y1")) for ln in vert}
    assert spans <= {line_h, line_h - line_h // 2}
    assert (line_h - line_h // 2) in spans       # at least one last child


def test_dash_threshold_and_longest_path(world, tmp_path):
    project, db = world
    tree = db.tree
    stats = db.stats()
    dist, portion, branch = compute_distances(tree, stats, db.k)
    finite = sorted(d for d in dist if d == d and d != 1)
    assert finite, "fixture must yield finite distances"
    # config range is [0, 1]; pick a value below at least one distance
    thresh = float(max(0.0, min(1.0, finite[0])))
    _, texts, lines = _render(project, db, tmp_path,
                              svgTooLargeDistance=str(thresh))
    horiz = [ln for ln in lines if ln.get("y1") == ln.get("y2")]
    font_height = int(round(0.8 * project["svgFontSize"])) + int(
        round(0.25 * project["svgFontSize"]))
    line_h = int(round(project["svgLineHeightFactor"] * font_height))
    dashed_rows = {(int(ln.get("y1")) - line_h // 2) // line_h
                   for ln in horiz if ln.get("stroke-dasharray")}
    want_dashed = {i for i in range(len(tree))
                   if tree.parent[i] >= 0 and dist[i] == dist[i]
                   and dist[i] > thresh}
    assert dashed_rows == want_dashed
    # longest-path child of each parent is drawn red (ref :190-199)
    red_rows = {(int(ln.get("y1")) - line_h // 2) // line_h
                for ln in horiz if ln.get("stroke") == "red"}
    want_red = {i for i in range(len(tree))
                if tree.parent[i] >= 0 and branch[int(tree.parent[i])] == i}
    assert red_rows == want_red
