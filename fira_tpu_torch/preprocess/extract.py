"""AST/graph extraction: diff chunks -> AST nodes, change nodes, edge lists.

Rebuilds the reference's per-chunk extraction worker
(Preprocess/process_data_ast_parallel.py and the GumTree
bridge get_ast_root_action.py) on top of the in-process native astdiff
component — no JVM, no temp files, no subprocesses.

Per update chunk (a delete-run followed by an add-run) the worker:
  1. reconstructs parseable Java from each fragment by bracket-balancing and
     wrapping in a ``class pad_pad_class`` shell per the reference's case
     analysis (process_data_ast_parallel.py:20-115, replicated exactly since
     which wrapper fires decides which AST exists and hence which edges);
  2. parses both versions (astdiff `parse`) and maps every AST leaf to a diff
     token position by ordered scanning (get_edge_ast_code, :132-185);
  3. tree-diffs old vs new (astdiff `diff`), reclassifies Match actions into
     match/update/move by joining against the Update/Move lists
     (get_ast_root_action.py:185-232), and emits one change node per
     surviving action with edges to the code/AST nodes it touches
     (get_edge_update, :187-298).
Context/pure-add/pure-delete chunks get only AST-structure edges
(get_edge_normal, :300-316).

Chunk-local indices are rebased into per-commit global coordinates and the
reassembled token stream must equal the original difftoken stream — the
reference's global invariant (:420).

Deliberately NOT replicated: the WASTE_TIME blocklist and CHANGE_SINGLE
input-rewrite tables (:16-17,38-39,123-124) — curated workarounds for inputs
that hang GumTree's JVM; the native parser handles or cleanly rejects them.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

from fira_tpu_torch.preprocess import astdiff_binding as astdiff
from fira_tpu_torch.preprocess.fsm import Chunk

MODIFIERS = (
    "abstract", "default", "final", "native", "private", "protected",
    "public", "static", "strictfp", "transient", "volatile",
)

_ACTOR_RE = re.compile(
    r"^(?P<typ>[A-Za-z]+)(?:: (?P<name>.+?))?\((?P<idx>\d+)\)$")


class ExtractError(ValueError):
    """Invariant violation inside extraction (the reference uses asserts)."""


# --------------------------------------------------------------------------
# Java fragment reconstruction (process_data_ast_parallel.py:20-115)
# --------------------------------------------------------------------------

def balance_brackets(tokens: List[str]) -> List[str]:
    """Drop a leading stray '}', then close unmatched braces on both sides
    (process_bracket, :20-35)."""
    tokens = list(tokens)
    if tokens and tokens[0] == "}":
        tokens.pop(0)
    stack: List[str] = []
    for token in tokens:
        if token == "{":
            stack.append("{")
        elif token == "}":
            if stack and stack[-1] == "{":
                stack.pop()
            else:
                stack.append("}")
    unmatched_close = stack.count("}")
    unmatched_open = stack.count("{")
    return ["{"] * unmatched_close + tokens + ["}"] * unmatched_open


def reconstruct_java(code_tokens: Sequence[str]) -> Optional[Tuple[str, int]]:
    """Fragment tokens -> (parseable Java text, char offset of the fragment).

    Returns None when the fragment is empty after cleaning — the chunk then
    degrades to code-tokens-only, like the reference on GumTree failure.
    The wrapper case analysis replicates get_ast (:37-115): which shell a
    fragment gets decides the AST shape, so parity here is parity of edges.
    """
    text = " ".join(code_tokens)
    for junk in ("COMMENT", "SINGLE", "<nl>", "<nb>"):
        text = text.replace(junk, " ")
    if not text.strip():
        return None
    toks = astdiff.tokenize(text)
    if not toks:
        return None

    # stray-token cleanup (:56-65): a lone 'implement' typo token, a trailing
    # 'implements', an unclosed trailing generic on a class header
    if "implement" in toks:
        toks.remove("implement")
    if toks and toks[-1] == "implements":
        toks.remove("implements")  # first occurrence, like the reference (:59)
    if not toks:
        return None
    if len(toks) >= 4 and "class" in toks and toks[-2] == "<" and toks[-1] != ">":
        toks.append(">")

    toks = balance_brackets(toks)
    if not toks:
        return None
    fragment = " ".join(toks)

    if toks[0] in ("import", "package"):
        wrapped = toks
    elif toks[0] == "@":
        if "class" in toks:  # annotated class definition parses as-is
            wrapped = toks
        else:  # annotated method: needs a class shell
            wrapped = ["class", "pad_pad_class", "{"] + toks + ["}"]
    elif toks[0] in MODIFIERS:
        if "class" in toks:  # class definition
            if toks[-1] == "}":
                wrapped = toks
            else:
                wrapped = toks + ["{", "}"]
        elif ("(" in toks and ")" in toks
              and ("=" not in toks
                   or (toks.index("(") < toks.index("=")
                       and toks.index(")") < toks.index("=")))):
            # method definition (possibly header-only)
            if toks[-1] == "}":
                pass
            elif toks[-1] != ";":
                toks = toks + ["{", "}"]
            wrapped = ["class", "pad_pad_class", "{"] + toks + ["}"]
        else:  # field definition: extra instance-initializer block shell
            wrapped = (["class", "pad_pad_class", "{", "{"] + toks
                       + ["}", "}"])
    elif toks[0] == "{":
        wrapped = ["class", "pad_pad_class", "{"] + toks + ["}"]
    else:  # statement fragment
        if toks[0] == "if" and toks[-1] == ")":
            toks = toks + ["{", "}"]
        wrapped = ["class", "pad_pad_class", "{", "{"] + toks + ["}", "}"]

    full = " ".join(wrapped)
    start = full.find(fragment)
    if start < 0:
        raise ExtractError("fragment lost during wrapping")
    return full, start


# --------------------------------------------------------------------------
# Parsed-tree view
# --------------------------------------------------------------------------

@dataclasses.dataclass
class AstNode:
    """Node of the parsed wrapped fragment (preorder id == astdiff JSON id)."""

    id: int
    type_label: str
    label: Optional[str]
    pos: int
    children: List["AstNode"]
    parent: Optional["AstNode"] = None


def build_tree(parsed: dict) -> List[AstNode]:
    """JSON tree -> preorder node list with parent links. NullLiteral /
    ThisExpression get their implicit labels injected, as the reference
    bridge does (get_ast_root_action.py:56-61)."""
    nodes: List[AstNode] = []

    def walk(j: dict, parent: Optional[AstNode]) -> None:
        label = j.get("label")
        if j["typeLabel"] == "NullLiteral":
            label = "null"
        elif j["typeLabel"] == "ThisExpression":
            label = "this"
        node = AstNode(id=j["id"], type_label=j["typeLabel"], label=label,
                       pos=j["pos"], children=[], parent=parent)
        if node.id != len(nodes):
            raise ExtractError("non-preorder ids in parse output")
        nodes.append(node)
        if parent is not None:
            parent.children.append(node)
        for c in j["children"]:
            walk(c, node)

    walk(parsed["root"], None)
    return nodes


# --------------------------------------------------------------------------
# AST <-> code mapping (get_edge_ast_code, :132-185)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class SideGraph:
    """One fragment version's AST contribution, chunk-local indices."""

    edge_ast_code: List[Tuple[int, int]]  # (ast_idx, code_token_idx)
    edge_ast: List[Tuple[int, int]]       # (parent_ast_idx, child_ast_idx)
    ast_tokens: List[str]                 # internal-node type labels
    dmap_ast: Dict[int, int]              # node id -> ast_idx
    dmap_code: Dict[int, int]             # leaf node id -> code_token_idx


def empty_side() -> SideGraph:
    return SideGraph([], [], [], {}, {})


def ast_code_edges(nodes: List[AstNode], codes: Sequence[str],
                   start_pos: int, *,
                   commit_index: Optional[int] = None) -> SideGraph:
    """Map leaves to diff-token positions by ordered scan; collect internal
    nodes as AST-type tokens and parent-child edges.

    Wrapper pruning: nodes positioned before the fragment (the shell tokens)
    are skipped, as are the CompilationUnit/Block that share the fragment's
    start offset (:143-146). Each leaf label is matched to the next unseen
    occurrence via ``codes.index(name, last+1)`` with per-name progress
    bookkeeping (:148-169); a leaf is connected through its PARENT's ast
    node (:171-172).
    """
    side = SideGraph([], [], [], {}, {})
    start_index: Dict[str, int] = {}
    pos_index: Dict[str, int] = {}
    codes = list(codes)
    for node in nodes:
        if node.pos < start_pos:
            continue
        if node.pos == start_pos and node.type_label in ("CompilationUnit",
                                                         "Block"):
            continue
        if not node.children and node.type_label != "Block":
            name = node.label
            if name is None:
                continue
            last = start_index.get(name, -1)
            if name in start_index and pos_index[name] >= node.pos:
                continue  # out-of-order revisit of an already-consumed label
            if name not in codes:
                continue
            # replicated per-corpus hack (:159-160): commit 70's 'nextParent'
            # leaf maps to the 'nextParent:' label token
            if commit_index == 70 and name == "nextParent" and last == -1:
                try:
                    code_no = codes.index("nextParent:", last + 1)
                except ValueError:
                    continue
            else:
                try:
                    code_no = codes.index(name, last + 1)
                except ValueError:
                    continue
            side.dmap_code[node.id] = code_no
            start_index[name] = code_no
            pos_index[name] = node.pos
            parent_ast = side.dmap_ast.get(node.parent.id)
            if parent_ast is None:
                raise ExtractError(
                    f"leaf {name!r} under pruned parent {node.parent.type_label}")
            side.edge_ast_code.append((parent_ast, code_no))
        else:
            side.dmap_ast[node.id] = len(side.ast_tokens)
            side.ast_tokens.append(node.type_label)
            parent = node.parent
            if parent is None or parent.pos < start_pos:
                continue
            if parent.pos == start_pos and parent.type_label in (
                    "CompilationUnit", "Block"):
                continue
            side.edge_ast.append((side.dmap_ast[parent.id],
                                  side.dmap_ast[node.id]))
    # one code token per AST leaf (:181-184)
    used = list(side.dmap_code.values())
    if len(used) != len(set(used)):
        raise ExtractError("code token claimed by two AST leaves")
    return side


def parse_fragment(code_tokens: Sequence[str], *,
                   commit_index: Optional[int] = None
                   ) -> Tuple[Optional[str], SideGraph]:
    """Reconstruct + parse + map one fragment. Returns (wrapped_text, side);
    text is None when the fragment doesn't parse (side is then empty)."""
    recon = reconstruct_java(code_tokens)
    if recon is None:
        return None, empty_side()
    text, start = recon
    parsed = astdiff.parse_json(text)
    if parsed is None:
        return None, empty_side()
    nodes = build_tree(parsed)
    return text, ast_code_edges(nodes, code_tokens, start,
                                commit_index=commit_index)


# --------------------------------------------------------------------------
# Action parsing + reclassification (get_ast_root_action.py:103-232)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Actor:
    typ: str
    idx: int
    name: Optional[str]


def _parse_actor(s: str) -> Actor:
    m = _ACTOR_RE.match(s.strip())
    if not m:
        raise ExtractError(f"malformed action node {s!r}")
    name = m.group("name")
    typ = m.group("typ")
    if name is None and typ == "NullLiteral":
        name = "null"
    if name is None and typ == "ThisExpression":
        name = "this"
    return Actor(typ, int(m.group("idx")), name)


@dataclasses.dataclass
class Actions:
    """(kind, old_actor, new_actor) triples for matched nodes, plus pure
    deletes (old side) and adds (new side)."""

    classified: List[Tuple[str, Actor, Actor]]
    deletes: List[Actor]
    adds: List[Actor]


def classify_actions(lines: Sequence[str]) -> Actions:
    """Split raw action lines and reclassify Match into match/update/move by
    joining against the Update/Move lists on the old node (:185-222); update
    wins when a node both moved and was renamed (:221-222)."""
    matches: List[Tuple[Actor, Actor]] = []
    deletes: List[Actor] = []
    updates: List[Tuple[Actor, str]] = []
    moves: List[Actor] = []
    adds: List[Actor] = []
    for raw in lines:
        line = raw.strip()
        if line.startswith("Match "):
            old_s, new_s = line[len("Match "):].rsplit(" to ", 1)
            matches.append((_parse_actor(old_s), _parse_actor(new_s)))
        elif line.startswith("Delete "):
            deletes.append(_parse_actor(line[len("Delete "):]))
        elif line.startswith("Update "):
            old_s, new_name = line[len("Update "):].split(" to ", 1)
            updates.append((_parse_actor(old_s), new_name.strip()))
        elif line.startswith("Move "):
            old_s, rest = line[len("Move "):].split(" into ", 1)
            moves.append(_parse_actor(old_s))
        elif line.startswith("Insert "):
            new_s, rest = line[len("Insert "):].split(" into ", 1)
            adds.append(_parse_actor(new_s))
        elif line:
            raise ExtractError(f"unrecognized action line {line!r}")

    consumed_updates = [False] * len(updates)
    consumed_moves = [False] * len(moves)
    classified: List[Tuple[str, Actor, Actor]] = []
    for old, new in matches:
        updated = moved = False
        for j, (u_old, u_name) in enumerate(updates):
            if u_old == old:
                if u_name != new.name:
                    raise ExtractError(
                        f"update target {u_name!r} != matched name {new.name!r}")
                updated = True
                consumed_updates[j] = True
                break
        for j, m_old in enumerate(moves):
            if m_old == old:
                moved = True
                consumed_moves[j] = True
                break
        kind = "update" if updated else ("move" if moved else "match")
        classified.append((kind, old, new))
    if not all(consumed_updates) or not all(consumed_moves):
        raise ExtractError("Update/Move action without a Match line")
    return Actions(classified, deletes, adds)


# --------------------------------------------------------------------------
# Per-chunk edge extraction (get_edge_update / get_edge_normal)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class ChunkGraph:
    """One chunk's contribution, chunk-local indices. For update chunks the
    new side's code indices are relative to the ADD fragment and its ast
    indices relative to the new side's own ast list; ``change`` labels are
    shared across both sides."""

    old: SideGraph = dataclasses.field(default_factory=empty_side)
    new: SideGraph = dataclasses.field(default_factory=empty_side)
    change: List[str] = dataclasses.field(default_factory=list)
    edge_change_code_old: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list)
    edge_change_code_new: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list)
    edge_change_ast_old: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list)
    edge_change_ast_new: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list)


def normal_chunk_edges(tokens: Sequence[str], *,
                       commit_index: Optional[int] = None) -> ChunkGraph:
    """Context / pure-add / pure-delete chunk: AST structure only (:300-316)."""
    g = ChunkGraph()
    _, g.old = parse_fragment(tokens, commit_index=commit_index)
    return g


def update_chunk_edges(old_tokens: Sequence[str], new_tokens: Sequence[str],
                       *, commit_index: Optional[int] = None) -> ChunkGraph:
    """Update chunk: both sides' AST edges plus one change node per diff
    action, wired to the code/AST nodes it touches (:187-298)."""
    g = ChunkGraph()
    text_old, g.old = parse_fragment(old_tokens, commit_index=commit_index)
    text_new, g.new = parse_fragment(new_tokens, commit_index=commit_index)
    if text_old is None or text_new is None:
        return g  # graceful degradation: code tokens only (:213-217)

    lines = astdiff.diff_lines(text_old, text_new)
    if lines is None:
        return g
    actions = classify_actions(lines)

    for kind, old, new in actions.classified:
        c = len(g.change)
        if old.idx in g.old.dmap_code:
            if new.idx not in g.new.dmap_code:
                continue
            g.edge_change_code_old.append((c, g.old.dmap_code[old.idx]))
            g.edge_change_code_new.append((c, g.new.dmap_code[new.idx]))
            g.change.append(kind)
        elif old.idx in g.old.dmap_ast:
            if new.idx not in g.new.dmap_ast:
                continue
            g.edge_change_ast_old.append((c, g.old.dmap_ast[old.idx]))
            g.edge_change_ast_new.append((c, g.new.dmap_ast[new.idx]))
            g.change.append(kind)
    for old in actions.deletes:
        c = len(g.change)
        if old.idx in g.old.dmap_code:
            g.edge_change_code_old.append((c, g.old.dmap_code[old.idx]))
            g.change.append("delete")
        elif old.idx in g.old.dmap_ast:
            g.edge_change_ast_old.append((c, g.old.dmap_ast[old.idx]))
            g.change.append("delete")
    for new in actions.adds:
        c = len(g.change)
        if new.idx in g.new.dmap_code:
            g.edge_change_code_new.append((c, g.new.dmap_code[new.idx]))
            g.change.append("add")
        elif new.idx in g.new.dmap_ast:
            g.edge_change_ast_new.append((c, g.new.dmap_ast[new.idx]))
            g.change.append("add")
    return g


# --------------------------------------------------------------------------
# Per-commit assembly (worker main loop, :344-426)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class CommitGraph:
    """The six per-commit graph streams of the DataSet schema."""

    ast: List[str]
    change: List[str]
    edge_ast: List[Tuple[int, int]]
    edge_ast_code: List[Tuple[int, int]]
    edge_change_ast: List[Tuple[int, int]]
    edge_change_code: List[Tuple[int, int]]


def extract_commit(chunks: Sequence[Chunk], types: Sequence[int],
                   diff_tokens: Sequence[str], *,
                   commit_index: Optional[int] = None,
                   memo=None) -> CommitGraph:
    """Rebase chunk-local indices into commit-global coordinates (:369-393)
    and verify the reassembled token stream equals the diff (:420).

    ``memo``: a hunk-level extraction memo (``ingest.cache.HunkMemo``):
    a chunk's parse/diff is a pure function of its typed tokens, so the
    ingest path reuses it across near-identical requests while this
    rebase runs per commit; the cached ChunkGraph is only read here."""
    out = CommitGraph([], [], [], [], [], [])
    all_token: List[str] = []
    for chunk, typ in zip(chunks, types):
        code_base = len(all_token)
        ast_base = len(out.ast)
        change_base = len(out.change)
        if typ == 100:
            old_tokens, new_tokens = chunk
            g = (memo.chunk_graph(chunk, typ, commit_index)
                 if memo is not None else
                 update_chunk_edges(old_tokens, new_tokens,
                                    commit_index=commit_index))
            n_ast_old = len(g.old.ast_tokens)
            n_code_old = len(old_tokens)
            for a, j in g.old.edge_ast_code:
                out.edge_ast_code.append((ast_base + a, code_base + j))
            for a1, a2 in g.old.edge_ast:
                out.edge_ast.append((ast_base + a1, ast_base + a2))
            for c, j in g.edge_change_code_old:
                out.edge_change_code.append((change_base + c, code_base + j))
            for c, a in g.edge_change_ast_old:
                out.edge_change_ast.append((change_base + c, ast_base + a))
            for a, j in g.new.edge_ast_code:
                out.edge_ast_code.append(
                    (ast_base + n_ast_old + a, code_base + n_code_old + j))
            for a1, a2 in g.new.edge_ast:
                out.edge_ast.append((ast_base + n_ast_old + a1,
                                     ast_base + n_ast_old + a2))
            for c, j in g.edge_change_code_new:
                out.edge_change_code.append(
                    (change_base + c, code_base + n_code_old + j))
            for c, a in g.edge_change_ast_new:
                out.edge_change_ast.append(
                    (change_base + c, ast_base + n_ast_old + a))
            out.ast.extend(g.old.ast_tokens)
            out.ast.extend(g.new.ast_tokens)
            out.change.extend(g.change)
            all_token.extend(old_tokens)
            all_token.extend(new_tokens)
        else:
            if typ not in (0, -1, 1):
                raise ExtractError(f"unknown chunk type {typ}")
            tokens = list(chunk)
            if not tokens:
                raise ExtractError("empty non-update chunk")
            g = (memo.chunk_graph(chunk, typ, commit_index)
                 if memo is not None else
                 normal_chunk_edges(tokens, commit_index=commit_index))
            for a, j in g.old.edge_ast_code:
                out.edge_ast_code.append((ast_base + a, code_base + j))
            for a1, a2 in g.old.edge_ast:
                out.edge_ast.append((ast_base + a1, ast_base + a2))
            out.ast.extend(g.old.ast_tokens)
            all_token.extend(tokens)
    if list(all_token) != list(diff_tokens):
        raise ExtractError(
            "reassembled chunk tokens disagree with the difftoken stream")
    return out
