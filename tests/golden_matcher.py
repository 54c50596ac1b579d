"""A direct, scalar re-implementation of the reference's per-read matching
algorithm (core match/FastqKMerMatcher.java:327-535 + tax/SmallTaxTree.java),
used as the golden model to verify the vectorized device pipeline against.

Deliberately written as a line-by-line transcription of the *semantics*
(rolling k-mers with bad-base skips, per-contig stats flush, vote counters,
path merge with maxPaths cap, tie handling, threshold promotion, error
thresholds) — not of the vectorized design, so the two implementations fail
independently.
"""

from dataclasses import dataclass, field

import numpy as np

from genestrip_tpu.utils.dna import BAD

INVALID = -2
MISS = -1


@dataclass
class GoldenStats:
    reads: int = 0
    reads1_kmer: int = 0
    reads_bps: int = 0
    reads_kmers: int = 0
    kmers: int = 0
    contigs: int = 0
    contig_sq: int = 0
    max_contig: int = 0
    max_contig_read: int = -1
    error_sum: float = 0.0
    error_sq: float = 0.0
    class_error_sum: float = 0.0
    class_error_sq: float = 0.0


class GoldenMatcher:
    """tree: SmallTaxTree-like (parent array, taxids); table: KmerTable."""

    def __init__(self, table, tree, k, max_paths=10, max_tax_err=-1.0,
                 max_class_err=-1.0, threshold=1, classify=True):
        self.table = table
        self.tree = tree
        self.k = k
        self.max_paths = max_paths
        self.max_tax_err = max_tax_err
        self.max_class_err = max_class_err
        self.threshold = threshold
        self.classify = classify
        T = len(tree)
        self.stats = [GoldenStats() for _ in range(T)]
        self.node_of_value = tree.node_of_value(table)
        self.seen = np.zeros(table.entries, bool)
        self.read_no = 0
        self.results = []   # per read: (class_node, segments, found)

    # -- SmallTaxTree ops ------------------------------------------------

    def is_ancestor_of(self, node, ancestor):
        while node >= 0:
            if node == ancestor:
                return True
            node = int(self.tree.parent[node])
        return False

    def sum_counts(self, node, votes):
        res = 0
        while node >= 0:
            res += votes.get(node, 0)
            node = int(self.tree.parent[node])
        return res

    def lowest_above_threshold(self, node, votes, threshold):
        res = 0
        while node >= 0:
            res += votes.get(node, 0)
            if res >= threshold:
                return node
            node = int(self.tree.parent[node])
        return -1

    def lca(self, a, b):
        if a == b:
            return a
        if a < 0 or b < 0:
            return -1
        da, db = int(self.tree.depth[a]), int(self.tree.depth[b])
        while da > db:
            a = int(self.tree.parent[a]); da -= 1
        while db > da:
            b = int(self.tree.parent[b]); db -= 1
        while a != b:
            a = int(self.tree.parent[a])
            b = int(self.tree.parent[b])
        return a

    # -- the matchRead transcription -------------------------------------

    def match_read(self, codes):
        """codes: uint8 array of one read. Mirrors matchRead step by step.

        Window k-mers and lookups are precomputed in bulk for speed; the
        iteration/skip/vote/merge semantics remain a faithful scalar
        transcription of the reference loop.
        """
        from genestrip_tpu.ops.kmer import window_kmers_np
        k = self.k
        tree = self.tree
        n = len(codes)
        mx = n - k + 1
        wk, wvalid = window_kmers_np(codes, k)
        wvi, wpos = self.table.get_np(wk) if mx > 0 else (None, None)
        found = False
        read_tax_err = 0 if self.classify else -1
        votes = {}
        paths = []          # candidate nodes, insertion order, capped
        segments = []       # (label, runlen) for kraken-style output
        last_tax = None     # None=start sentinel; else node index / MISS / INVALID
        contig_len = 0
        read_no = self.read_no
        self.read_no += 1
        per_read_seen_nodes = set()

        i = 0
        old_index = 0
        while i < mx:
            if not wvalid[i]:
                win = codes[i:i + k]
                badpos = i + int(np.nonzero(win > 3)[0][0])
                old_index = i
                i_eff = badpos
                node = INVALID
            else:
                if wvi[i] >= 0 and self.node_of_value[wvi[i]] >= 0:
                    node = int(self.node_of_value[wvi[i]])
                    store_pos = int(wpos[i])
                else:
                    node = MISS
                i_eff = i

            new_contig = node != last_tax
            if read_tax_err != -1:
                if node in (MISS, INVALID):
                    read_tax_err += 1
                    if self.max_tax_err >= 0:
                        if (self.max_tax_err >= 1 and read_tax_err > self.max_tax_err) \
                                or (read_tax_err > self.max_tax_err * mx):
                            read_tax_err = -1
                else:
                    votes[node] = votes.get(node, 0) + 1
                    if new_contig:
                        self._merge_path(node, paths)
            if node != last_tax:
                if contig_len > 0:
                    segments.append((last_tax, contig_len))
                    if last_tax is not None and last_tax >= 0:
                        st = self.stats[last_tax]
                        st.kmers += contig_len
                        st.contigs += 1
                        st.contig_sq += contig_len * contig_len
                        if contig_len > st.max_contig:
                            st.max_contig = contig_len
                            st.max_contig_read = read_no
                    contig_len = 0
            if node == INVALID:
                contig_len += (mx - old_index) if i_eff >= mx else (i_eff - old_index + 1)
            else:
                contig_len += 1
            last_tax = node
            if node >= 0:
                found = True
                if new_contig and node not in per_read_seen_nodes:
                    per_read_seen_nodes.add(node)
                    self.stats[node].reads1_kmer += 1
                self.seen[store_pos] = True
            i = i_eff + 1

        if contig_len > 0:
            segments.append((last_tax, contig_len))
        class_node = -1
        if found:
            if contig_len > 0 and last_tax is not None and last_tax >= 0:
                st = self.stats[last_tax]
                st.kmers += contig_len
                st.contigs += 1
                st.contig_sq += contig_len * contig_len
                if contig_len > st.max_contig:
                    st.max_contig = contig_len
                    st.max_contig_read = read_no
            if read_tax_err != -1:
                # winner selection (ref :474-497)
                counts0 = 0
                slots = list(paths)
                best_slots = [None] * max(len(slots) + 1, 1)
                ties = 0
                for nd in slots:
                    sm = self.sum_counts(nd, votes)
                    if sm > counts0:
                        counts0 = sm
                        best_slots[0] = nd
                        ties = 0
                    elif sm == counts0:
                        ties += 1
                        best_slots[ties] = nd
                if self.threshold > 1:
                    for j in range(ties + 1):
                        if best_slots[j] is not None:
                            best_slots[j] = self.lowest_above_threshold(
                                best_slots[j], votes, self.threshold)
                            if best_slots[j] == -1:
                                best_slots[j] = None
                node = best_slots[0] if best_slots[0] is not None else -1
                for j in range(1, ties + 1):
                    node = self.lca(node, best_slots[j] if best_slots[j] is not None else -1)
                class_node = node
                if node >= 0:
                    if ties > 0 or self.threshold > 1:
                        read_kmers = self.sum_counts(best_slots[0], votes)
                    else:
                        read_kmers = counts0
                    class_err_c = mx - read_kmers
                    B = self.max_class_err
                    if B < 0 or (B >= 1 and class_err_c <= B) or (class_err_c <= B * mx):
                        err = read_tax_err / mx
                        cerr = class_err_c / mx
                        st = self.stats[node]
                        st.reads += 1
                        st.reads_kmers += read_kmers
                        st.reads_bps += n
                        st.error_sum += err
                        st.error_sq += err * err
                        st.class_error_sum += cerr
                        st.class_error_sq += cerr * cerr
                else:
                    found = False
        self.results.append((class_node, segments, found))
        return class_node, segments, found

    def _merge_path(self, node, paths):
        """ref mergeReadTaxidPath:568-586."""
        for i, p in enumerate(paths):
            if self.is_ancestor_of(node, p):      # p is ancestor-or-eq of node
                paths[i] = node
                return
            if self.is_ancestor_of(p, node):      # node is ancestor-or-eq of p
                return
        if len(paths) < self.max_paths:
            paths.append(node)

    def unique_per_node(self):
        out = np.zeros(len(self.tree), np.int64)
        vi = self.table.value_idx[self.seen]
        nodes = self.node_of_value[vi]
        np.add.at(out, nodes[nodes >= 0], 1)
        return out
