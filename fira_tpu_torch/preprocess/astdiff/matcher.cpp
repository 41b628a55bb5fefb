// GumTree-style tree matching + Chawathe-style edit actions.
//
// Reimplements (from the algorithm, not the code) what the reference gets
// from `gumtree diff a.java b.java` (get_ast_root_action.py:123-171):
//   phase 1  top-down: greedily map isomorphic subtrees, tallest first
//            (subtree hash equality), unique pairs first, ambiguous pairs
//            resolved by parent-mapping agreement then source position;
//   phase 2  bottom-up: an unmatched old container is mapped to the
//            same-type new container sharing the most mapped descendants
//            (dice > 0.5, always for the roots), followed by a last-chance
//            recovery pass pairing leftover same-type/label descendants;
//   actions  Update (label changed), Move (parent mapping disagrees, or
//            child order changed per LCS alignment), Insert / Delete
//            (unmapped), each printed in the exact text the reference
//            bridge parses and re-asserts against both trees.
#include "astdiff.hpp"

#include <algorithm>
#include <cstdlib>
#include <map>
#include <sstream>
#include <unordered_map>
#include <unordered_set>

namespace astdiff {

namespace {

constexpr int kMinHeight = 2;      // GumTree default: subtrees shorter than
                                   // this are left to the bottom-up phase
constexpr double kDiceThreshold = 0.5;

void collect_descendants(const Node* n, std::vector<const Node*>& out) {
  for (const Node* c : n->children) {
    out.push_back(c);
    collect_descendants(c, out);
  }
}

// Map an isomorphic pair subtree-wide (equal hashes => equal shape).
void map_isomorphic(const Node* o, const Node* n, Mapping& m) {
  if (m.o2n[o->id] != -1 || m.n2o[n->id] != -1) return;
  m.o2n[o->id] = n->id;
  m.n2o[n->id] = o->id;
  for (size_t i = 0; i < o->children.size() && i < n->children.size(); ++i)
    map_isomorphic(o->children[i], n->children[i], m);
}

struct HeightList {
  // max-height priority structure over open nodes
  std::map<int, std::vector<Node*>, std::greater<int>> by_height;
  void push(Node* n) { by_height[n->height].push_back(n); }
  int peek() const { return by_height.empty() ? -1 : by_height.begin()->first; }
  std::vector<Node*> pop() {
    auto v = std::move(by_height.begin()->second);
    by_height.erase(by_height.begin());
    return v;
  }
  void open(Node* n) {
    for (Node* c : n->children) push(c);
  }
};

// `od` = o's descendants, precomputed by the caller (shared across the
// candidate loop).
double dice(const std::vector<const Node*>& od, const Node* n,
            const Mapping& m) {
  const size_t n_desc = static_cast<size_t>(n->size) - 1;
  if (od.empty() && n_desc == 0) return 0.0;
  int common = 0;
  for (const Node* d : od) {
    int t = m.o2n[d->id];
    if (t == -1) continue;
    // target inside n's subtree?
    // (ids are preorder: inside iff n.id < t <= n.id + n.size - 1)
    if (t > n->id && t < n->id + n->size) ++common;
  }
  return 2.0 * common / (static_cast<double>(od.size()) + n_desc);
}

std::string node_key(const Node* x) {
  return x->typeLabel + "\x01" + (x->has_label ? x->label : std::string());
}

// Position-respecting recovery: LCS-align the children of a matched pair on
// (typeLabel, label) keys, map aligned unmatched pairs, recurse into them.
// Approximates GumTree's optimal last-chance mapping for containers.
void align_children(const Node* o, const Node* n, Mapping& m) {
  const auto& a = o->children;
  const auto& b = n->children;
  if (a.empty() || b.empty()) return;
  std::vector<std::string> ka(a.size()), kb(b.size());
  for (size_t i = 0; i < a.size(); ++i) ka[i] = node_key(a[i]);
  for (size_t j = 0; j < b.size(); ++j) kb[j] = node_key(b[j]);
  std::vector<std::vector<int>> dp(a.size() + 1,
                                   std::vector<int>(b.size() + 1, 0));
  for (size_t i = a.size(); i-- > 0;)
    for (size_t j = b.size(); j-- > 0;)
      dp[i][j] = (ka[i] == kb[j]) ? dp[i + 1][j + 1] + 1
                                  : std::max(dp[i + 1][j], dp[i][j + 1]);
  for (size_t i = 0, j = 0; i < a.size() && j < b.size();) {
    if (ka[i] == kb[j]) {
      if (m.o2n[a[i]->id] == -1 && m.n2o[b[j]->id] == -1) {
        m.o2n[a[i]->id] = b[j]->id;
        m.n2o[b[j]->id] = a[i]->id;
      }
      if (m.o2n[a[i]->id] == b[j]->id) align_children(a[i], b[j], m);
      ++i; ++j;
    } else if (dp[i + 1][j] >= dp[i][j + 1]) {
      ++i;
    } else {
      ++j;
    }
  }
}

void last_chance(const Node* o, const Node* n, Mapping& m) {
  align_children(o, n, m);
  std::vector<const Node*> od, nd;
  collect_descendants(o, od);
  collect_descendants(n, nd);
  // leftover pass: unique (type,label) pairs, then unique same-type pairs —
  // catches moved nodes the positional alignment couldn't reach
  for (int pass = 0; pass < 2; ++pass) {
    std::unordered_map<std::string, std::vector<const Node*>> og, ng;
    for (const Node* d : od)
      if (m.o2n[d->id] == -1)
        og[pass == 0 ? node_key(d) : d->typeLabel].push_back(d);
    for (const Node* d : nd)
      if (m.n2o[d->id] == -1)
        ng[pass == 0 ? node_key(d) : d->typeLabel].push_back(d);
    for (auto& [k, olds] : og) {
      auto it = ng.find(k);
      if (it == ng.end()) continue;
      auto& news = it->second;
      if (olds.size() == 1 && news.size() == 1) {
        m.o2n[olds[0]->id] = news[0]->id;
        m.n2o[news[0]->id] = olds[0]->id;
        align_children(olds[0], news[0], m);
      }
    }
  }
}

}  // namespace

Mapping match_trees(const Tree& told, const Tree& tnew) {
  Mapping m;
  m.o2n.assign(told.preorder.size(), -1);
  m.n2o.assign(tnew.preorder.size(), -1);

  // ---- phase 1: top-down greedy isomorphic subtree matching ----
  HeightList l1, l2;
  l1.push(told.root);
  l2.push(tnew.root);
  while (std::min(l1.peek(), l2.peek()) >= kMinHeight) {
    if (l1.peek() != l2.peek()) {
      if (l1.peek() > l2.peek())
        for (Node* t : l1.pop()) l1.open(t);
      else
        for (Node* t : l2.pop()) l2.open(t);
      continue;
    }
    std::vector<Node*> olds = l1.pop(), news = l2.pop();
    std::unordered_map<uint64_t, std::vector<Node*>> oh, nh;
    for (Node* t : olds) oh[t->hash].push_back(t);
    for (Node* t : news) nh[t->hash].push_back(t);
    // unique-unique first, then ambiguous resolved by parent mapping / pos
    for (auto& [h, ov] : oh) {
      auto it = nh.find(h);
      if (it == nh.end()) continue;
      auto& nv = it->second;
      if (ov.size() == 1 && nv.size() == 1) {
        map_isomorphic(ov[0], nv[0], m);
      } else {
        struct Cand { Node* o; Node* n; int parent_ok; int posdiff; };
        std::vector<Cand> cands;
        for (Node* o : ov)
          for (Node* n : nv) {
            int pok = (o->parent && n->parent &&
                       m.o2n[o->parent->id] == n->parent->id)
                          ? 1 : 0;
            cands.push_back({o, n, pok, std::abs(o->pos - n->pos)});
          }
        std::stable_sort(cands.begin(), cands.end(),
                         [](const Cand& a, const Cand& b) {
                           if (a.parent_ok != b.parent_ok)
                             return a.parent_ok > b.parent_ok;
                           return a.posdiff < b.posdiff;
                         });
        for (auto& c : cands)
          if (m.o2n[c.o->id] == -1 && m.n2o[c.n->id] == -1)
            map_isomorphic(c.o, c.n, m);
      }
    }
    for (Node* t : olds)
      if (m.o2n[t->id] == -1) l1.open(t);
    for (Node* t : news)
      if (m.n2o[t->id] == -1) l2.open(t);
  }

  // ---- phase 2: bottom-up container matching ----
  // postorder = reverse preorder works for "children before parents" here
  for (auto it = told.preorder.rbegin(); it != told.preorder.rend(); ++it) {
    Node* o = *it;
    if (m.o2n[o->id] != -1 || o->children.empty()) continue;
    bool is_root = (o->parent == nullptr);
    // candidates: ancestors of mappings of o's matched descendants with the
    // same typeLabel
    std::vector<const Node*> od;
    collect_descendants(o, od);
    std::unordered_set<int> candidates;
    for (const Node* d : od) {
      int t = m.o2n[d->id];
      if (t == -1) continue;
      const Node* a = tnew.preorder[t]->parent;
      while (a) {
        if (a->typeLabel == o->typeLabel && m.n2o[a->id] == -1)
          candidates.insert(a->id);
        a = a->parent;
      }
    }
    const Node* best = nullptr;
    double best_dice = -1.0;
    for (int nid : candidates) {
      const Node* c = tnew.preorder[nid];
      double d = dice(od, c, m);
      if (d > best_dice) { best_dice = d; best = c; }
    }
    if (best && (best_dice > kDiceThreshold || is_root)) {
      m.o2n[o->id] = best->id;
      m.n2o[best->id] = o->id;
      last_chance(o, best, m);
    }
  }
  // roots always correspond (both CompilationUnit)
  if (m.o2n[told.root->id] == -1 && m.n2o[tnew.root->id] == -1 &&
      told.root->typeLabel == tnew.root->typeLabel) {
    m.o2n[told.root->id] = tnew.root->id;
    m.n2o[tnew.root->id] = told.root->id;
    last_chance(told.root, tnew.root, m);
  }
  return m;
}

// ------------------------------------------------------------- printing ---
namespace {

std::string fmt_node(const Node* n) {
  std::ostringstream os;
  os << n->typeLabel;
  if (n->has_label) os << ": " << n->label;
  os << "(" << n->id << ")";
  return os.str();
}

int child_index(const Node* parent, const Node* child) {
  for (size_t i = 0; i < parent->children.size(); ++i)
    if (parent->children[i] == child) return static_cast<int>(i);
  return 0;
}

}  // namespace

std::string diff_actions(const Tree& told, const Tree& tnew) {
  Mapping m = match_trees(told, tnew);
  std::ostringstream out;

  // Match lines: every mapped pair, old-preorder order.
  for (const Node* o : told.preorder) {
    int t = m.o2n[o->id];
    if (t == -1) continue;
    out << "Match " << fmt_node(o) << " to " << fmt_node(tnew.preorder[t])
        << "\n";
  }

  // Updates: label changed on a mapped pair.
  for (const Node* o : told.preorder) {
    int t = m.o2n[o->id];
    if (t == -1) continue;
    const Node* n = tnew.preorder[t];
    const std::string ol = o->has_label ? o->label : std::string();
    const std::string nl = n->has_label ? n->label : std::string();
    if (ol != nl) out << "Update " << fmt_node(o) << " to " << nl << "\n";
  }

  // Moves, part 1: parent mapping disagrees.
  std::vector<bool> moved(told.preorder.size(), false);
  for (const Node* o : told.preorder) {
    int t = m.o2n[o->id];
    if (t == -1 || !o->parent) continue;
    const Node* n = tnew.preorder[t];
    if (!n->parent) continue;
    if (m.o2n[o->parent->id] != n->parent->id) {
      moved[o->id] = true;
      out << "Move " << fmt_node(o) << " into " << fmt_node(n->parent)
          << " at " << child_index(n->parent, n) << "\n";
    }
  }
  // Moves, part 2: order changed among siblings mapped to the same parent —
  // LCS alignment; mapped child pairs outside the LCS are moves.
  for (const Node* po : told.preorder) {
    int pt = m.o2n[po->id];
    if (pt == -1) continue;
    const Node* pn = tnew.preorder[pt];
    std::vector<const Node*> s1, s2;
    for (const Node* c : po->children) {
      int t = m.o2n[c->id];
      if (t != -1 && tnew.preorder[t]->parent == pn && !moved[c->id])
        s1.push_back(c);
    }
    for (const Node* d : pn->children) {
      int t = m.n2o[d->id];
      if (t != -1 && told.preorder[t]->parent == po) s2.push_back(d);
    }
    if (s1.size() <= 1) continue;
    // LCS over (s1, s2) with equality "mapped to each other"
    size_t a = s1.size(), b = s2.size();
    std::vector<std::vector<int>> dp(a + 1, std::vector<int>(b + 1, 0));
    for (size_t i = a; i-- > 0;)
      for (size_t j = b; j-- > 0;)
        dp[i][j] = (m.o2n[s1[i]->id] == s2[j]->id)
                       ? dp[i + 1][j + 1] + 1
                       : std::max(dp[i + 1][j], dp[i][j + 1]);
    std::vector<bool> in_lcs(a, false);
    for (size_t i = 0, j = 0; i < a && j < b;) {
      if (m.o2n[s1[i]->id] == s2[j]->id) { in_lcs[i] = true; ++i; ++j; }
      else if (dp[i + 1][j] >= dp[i][j + 1]) ++i;
      else ++j;
    }
    for (size_t i = 0; i < a; ++i) {
      if (in_lcs[i] || moved[s1[i]->id]) continue;
      const Node* n = tnew.preorder[m.o2n[s1[i]->id]];
      moved[s1[i]->id] = true;
      out << "Move " << fmt_node(s1[i]) << " into " << fmt_node(pn) << " at "
          << child_index(pn, n) << "\n";
    }
  }

  // Inserts: unmapped new nodes (preorder).
  for (const Node* n : tnew.preorder) {
    if (m.n2o[n->id] != -1 || !n->parent) continue;
    out << "Insert " << fmt_node(n) << " into " << fmt_node(n->parent)
        << " at " << child_index(n->parent, n) << "\n";
  }
  // Deletes: unmapped old nodes (preorder).
  for (const Node* o : told.preorder) {
    if (m.o2n[o->id] != -1 || !o->parent) continue;
    out << "Delete " << fmt_node(o) << "\n";
  }
  return out.str();
}

// ---------------------------------------------------------------- JSON ----
namespace {

void json_escape(const std::string& s, std::ostringstream& os) {
  for (char c : s) {
    switch (c) {
      case '"': os << "\\\""; break;
      case '\\': os << "\\\\"; break;
      case '\n': os << "\\n"; break;
      case '\r': os << "\\r"; break;
      case '\t': os << "\\t"; break;
      default:
        if (static_cast<unsigned char>(c) < 0x20) {
          char buf[8];
          std::snprintf(buf, sizeof(buf), "\\u%04x", c);
          os << buf;
        } else {
          os << c;
        }
    }
  }
}

int type_code(const std::string& label) {
  // Stable small integers; the bridge stores but never consumes them
  // (get_ast_root_action.py:51), so this only needs determinism.
  static const std::vector<std::string> known = {
      "CompilationUnit", "PackageDeclaration", "ImportDeclaration",
      "TypeDeclaration", "EnumDeclaration", "EnumConstantDeclaration",
      "AnnotationTypeDeclaration", "AnnotationTypeMemberDeclaration",
      "AnonymousClassDeclaration", "TypeParameter", "FieldDeclaration",
      "MethodDeclaration", "SingleVariableDeclaration",
      "VariableDeclarationFragment", "VariableDeclarationStatement",
      "VariableDeclarationExpression", "Initializer", "Block",
      "ExpressionStatement", "IfStatement", "ForStatement",
      "EnhancedForStatement", "WhileStatement", "DoStatement", "TryStatement",
      "CatchClause", "SwitchStatement", "SwitchCase", "BreakStatement",
      "ContinueStatement", "ReturnStatement", "ThrowStatement",
      "SynchronizedStatement", "LabeledStatement", "AssertStatement",
      "TypeDeclarationStatement", "ConstructorInvocation",
      "SuperConstructorInvocation", "MethodInvocation",
      "SuperMethodInvocation", "ClassInstanceCreation", "FieldAccess",
      "SuperFieldAccess", "ArrayAccess", "ArrayCreation", "ArrayInitializer",
      "Assignment", "InfixExpression", "PrefixExpression",
      "PostfixExpression", "ConditionalExpression", "CastExpression",
      "InstanceofExpression", "ParenthesizedExpression", "TypeLiteral",
      "SimpleType", "QualifiedType", "ParameterizedType", "ArrayType",
      "WildcardType", "UnionType", "MarkerAnnotation", "NormalAnnotation",
      "SingleMemberAnnotation", "MemberValuePair", "SimpleName",
      "QualifiedName", "PrimitiveType", "Modifier", "NumberLiteral",
      "StringLiteral", "CharacterLiteral", "BooleanLiteral", "NullLiteral",
      "ThisExpression", "EmptyStatement", "LambdaExpression",
      "ExpressionMethodReference"};
  for (size_t i = 0; i < known.size(); ++i)
    if (known[i] == label) return static_cast<int>(i);
  return 999;
}

void node_json(const Node* n, std::ostringstream& os) {
  os << "{\"id\":" << n->id << ",\"type\":" << type_code(n->typeLabel)
     << ",\"typeLabel\":\"";
  json_escape(n->typeLabel, os);
  os << "\",\"pos\":" << n->pos << ",\"length\":" << n->length;
  if (n->has_label) {
    os << ",\"label\":\"";
    json_escape(n->label, os);
    os << "\"";
  }
  os << ",\"children\":[";
  for (size_t i = 0; i < n->children.size(); ++i) {
    if (i) os << ",";
    node_json(n->children[i], os);
  }
  os << "]}";
}

}  // namespace

std::string to_json(const Tree& t) {
  std::ostringstream os;
  os << "{\"root\":";
  node_json(t.root, os);
  os << "}";
  return os.str();
}

}  // namespace astdiff
