// astdiff: native Java AST parse + GumTree-style tree diff.
//
// TPU-native replacement for the reference's vendored Java GumTree 2.1.2
// distribution (gumtree/, consumed through two CLI contracts
// in Preprocess/get_ast_root_action.py:69-101 `parse` and
// :123-171 `diff`). Implemented from scratch in C++ so the preprocessing
// pipeline needs no JVM and no subprocess-per-chunk: the library is loaded
// once per worker via ctypes and called in-process.
//
// Contracts honoured (the ONLY interface the pipeline depends on):
//   parse:  Java source -> JSON {"root": {id,type,typeLabel,pos,length,
//           children[,label]}}  (leaf label == exact source token text;
//           NullLiteral / ThisExpression carry NO label)
//   diff:   old source + new source -> text lines
//           "Match T[: name](id) to T[: name](id)"
//           "Update T[: name](id) to newname"
//           "Move T[: name](id) into T[: name](id) at k"
//           "Insert T[: name](id) into T[: name](id) at k"
//           "Delete T[: name](id)"
//           where every Move/Update old node also appears in a Match line and
//           every Insert/Move target parent really owns the named child —
//           the invariants the reference bridge asserts.
#pragma once

#include <cstdint>
#include <memory>
#include <stdexcept>
#include <string>
#include <vector>

namespace astdiff {

// ---------------------------------------------------------------- tokens ---
enum class Tok : uint8_t {
  Ident,
  Keyword,
  Number,
  String,
  Char,
  Op,
  End,
};

struct Token {
  Tok kind;
  std::string text;
  int pos;  // char offset in source
};

struct LexError : std::runtime_error {
  explicit LexError(const std::string& m) : std::runtime_error(m) {}
};

// Tokenize Java source. Comments/whitespace dropped. Throws LexError.
std::vector<Token> lex(const std::string& src);

// ------------------------------------------------------------------ trees ---
struct Node {
  int id = -1;  // preorder index, assigned after parse
  std::string typeLabel;
  std::string label;      // leaf: exact source token text; infix/assign ops
  bool has_label = false; // NullLiteral/ThisExpression: false by contract
  int pos = 0;
  int length = 0;
  std::vector<Node*> children;
  Node* parent = nullptr;

  // matcher scratch
  int height = 0;
  int size = 1;
  uint64_t hash = 0;
};

// Owns every node; Node* stay valid for the Tree's lifetime.
struct Tree {
  std::vector<std::unique_ptr<Node>> arena;
  Node* root = nullptr;
  std::vector<Node*> preorder;  // preorder[i]->id == i

  Node* make(const std::string& typeLabel) {
    arena.push_back(std::make_unique<Node>());
    arena.back()->typeLabel = typeLabel;
    return arena.back().get();
  }
  void finalize();  // assign ids/parents/heights/hashes, fill preorder
};

struct ParseError : std::runtime_error {
  explicit ParseError(const std::string& m) : std::runtime_error(m) {}
};

// Parse a Java compilation unit (the wrapped fragments the FIRA pipeline
// feeds: always a parseable unit starting with package/import/annotation/
// modifier/class). Throws ParseError / LexError on anything it can't handle;
// callers degrade the chunk to code-tokens-only, exactly like the reference
// does when GumTree fails (process_data_ast_parallel.py:204-217).
std::unique_ptr<Tree> parse(const std::string& src);

// JSON per the `parse` contract.
std::string to_json(const Tree& t);

// ------------------------------------------------------------------- diff ---
struct Mapping {
  // old preorder id -> new preorder id (-1 = unmatched), and inverse.
  std::vector<int> o2n, n2o;
};

Mapping match_trees(const Tree& told, const Tree& tnew);

// Action script text per the `diff` contract (includes all Match lines).
std::string diff_actions(const Tree& told, const Tree& tnew);

}  // namespace astdiff
