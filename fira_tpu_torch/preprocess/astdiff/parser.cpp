// Recursive-descent Java parser producing JDT-shaped trees.
//
// Shape contract (mirrors what the reference pipeline observably depends on,
// Preprocess/get_ast_root_action.py + the 71-entry
// ast_change_vocab.json whose 65 AST labels are exactly the internal node
// kinds that may appear):
//   * every LEAF's label is the exact source token text, so the bridge's
//     ordered `codes.index(name)` scan (process_data_ast_parallel.py:157-168)
//     maps it to a diff-token position;
//   * NullLiteral and ThisExpression leaves carry NO label (the bridge
//     asserts this and substitutes 'null'/'this', get_ast_root_action.py:56-61);
//   * Names are leaves — a dotted chain `a.b.c` is ONE QualifiedName leaf with
//     the dotted label (never an internal node: 'qualifiedname' is absent from
//     the reference vocab, so the reference's GumTree produced only leaf
//     Names); dotted labels never match single diff tokens and are skipped by
//     the bridge, matching reference behavior;
//   * Modifier / PrimitiveType are leaves labelled with their token;
//   * Infix/Prefix/Postfix/Assignment nodes carry the operator as label
//     (internal-node labels only participate in diff Update actions);
//   * node.pos/length are char offsets into the source, pos == first
//     descendant token's offset (the bridge prunes wrapper-class nodes by
//     comparing pos against the fragment start, process_data_ast_parallel.py:143-146).
//
// Anything outside the supported grammar throws ParseError; callers degrade
// that chunk to code-tokens-only exactly like the reference does when its
// GumTree subprocess fails.
#include "astdiff.hpp"

#include <functional>

namespace astdiff {

namespace {

bool is_modifier(const std::string& s) {
  static const char* mods[] = {"public",    "protected", "private",  "static",
                               "abstract",  "final",     "native",   "synchronized",
                               "transient", "volatile",  "strictfp", "default"};
  for (const char* m : mods)
    if (s == m) return true;
  return false;
}

bool is_primitive(const std::string& s) {
  static const char* prims[] = {"boolean", "byte",  "char", "short",
                                "int",     "long",  "float", "double", "void"};
  for (const char* m : prims)
    if (s == m) return true;
  return false;
}

class Parser {
 public:
  explicit Parser(const std::string& src) : src_(src), toks_(lex(src)) {
    tree_ = std::make_unique<Tree>();
  }

  std::unique_ptr<Tree> run() {
    Node* cu = node("CompilationUnit");
    size_t s = mark();
    while (!at_end()) {
      if (at_op(";")) { advance(); continue; }
      size_t before = p_;
      if (at_kw("package")) {
        cu->children.push_back(parse_package());
      } else if (at_kw("import")) {
        cu->children.push_back(parse_import());
      } else {
        cu->children.push_back(parse_type_declaration());
      }
      if (p_ == before) err("parser made no progress");
    }
    finish(cu, s);
    if (cu->children.empty()) err("empty compilation unit");
    tree_->root = cu;
    tree_->finalize();
    return std::move(tree_);
  }

 private:
  const std::string& src_;
  std::vector<Token> toks_;
  size_t p_ = 0;
  std::unique_ptr<Tree> tree_;
  // undo log for '>' splitting so speculative parses can rewind cleanly
  std::vector<std::pair<size_t, Token>> undo_;

  // Recursion bound: the library runs in-process (ctypes), so pathological
  // nesting must become ParseError, not a C-stack overflow taking the whole
  // Python worker down. 300 levels also keeps the emitted JSON within
  // Python's default json.loads recursion budget.
  static constexpr int kMaxDepth = 300;
  int depth_ = 0;
  int switch_expr_depth_ = 0;  // yield is a statement ONLY inside switch
                               // EXPRESSION bodies (JLS 14.21) — in switch
                               // STATEMENTS 'yield' stays an identifier
  struct DepthGuard {
    Parser& p;
    explicit DepthGuard(Parser& pp) : p(pp) {
      if (p.depth_ >= kMaxDepth) p.err("nesting too deep");
      ++p.depth_;
    }
    ~DepthGuard() { --p.depth_; }
  };

  // RAII like DepthGuard: speculative-parse catches restore token
  // position but not counters, so the expression-switch depth must unwind
  // on ANY exit (a leak would misparse later 'yield' identifiers)
  struct SwitchExprGuard {
    Parser& p;
    bool on;
    SwitchExprGuard(Parser& pp, bool is_expr) : p(pp), on(is_expr) {
      if (on) ++p.switch_expr_depth_;
    }
    ~SwitchExprGuard() { if (on) --p.switch_expr_depth_; }
  };

  struct State { size_t p, undo; };
  State save() { return {p_, undo_.size()}; }
  void restore(const State& st) {
    while (undo_.size() > st.undo) {
      toks_[undo_.back().first] = undo_.back().second;
      undo_.pop_back();
    }
    p_ = st.p;
  }

  [[noreturn]] void err(const std::string& m) {
    throw ParseError(m + " near '" + cur().text + "' @" +
                     std::to_string(cur().pos));
  }
  const Token& cur() const { return toks_[p_]; }
  const Token& peek(size_t k = 1) const {
    return toks_[std::min(p_ + k, toks_.size() - 1)];
  }
  bool at_end() const { return cur().kind == Tok::End; }
  bool at_op(const char* s) const { return cur().kind == Tok::Op && cur().text == s; }
  bool at_kw(const char* s) const { return cur().kind == Tok::Keyword && cur().text == s; }
  bool at_ident() const { return cur().kind == Tok::Ident; }
  const Token& advance() { return toks_[p_++]; }
  void expect_op(const char* s) { if (!at_op(s)) err(std::string("expected '") + s + "'"); advance(); }
  void expect_kw(const char* s) { if (!at_kw(s)) err(std::string("expected '") + s + "'"); advance(); }
  Token expect_ident() {
    if (!at_ident()) err("expected identifier");
    return advance();
  }

  // Consume one '>' even when the lexer munched '>>', '>>=', '>=', etc.
  void expect_gt() {
    if (at_op(">")) { advance(); return; }
    if (cur().kind == Tok::Op && !cur().text.empty() && cur().text[0] == '>') {
      undo_.emplace_back(p_, cur());
      toks_[p_].text = cur().text.substr(1);
      toks_[p_].pos += 1;
      return;
    }
    err("expected '>'");
  }

  size_t mark() const { return p_; }
  Node* node(const char* typeLabel) { return tree_->make(typeLabel); }
  void finish(Node* n, size_t start_tok) {
    n->pos = toks_[start_tok].pos;
    const Token& last = toks_[p_ > start_tok ? p_ - 1 : start_tok];
    n->length = last.pos + static_cast<int>(last.text.size()) - n->pos;
  }
  Node* leaf(const char* typeLabel, const Token& tk, bool with_label = true) {
    Node* n = node(typeLabel);
    n->pos = tk.pos;
    n->length = static_cast<int>(tk.text.size());
    if (with_label) { n->label = tk.text; n->has_label = true; }
    return n;
  }

  // ------------------------------------------------------------- names ----
  // Dotted name as ONE leaf (SimpleName if undotted, QualifiedName if dotted).
  Node* parse_name_leaf() {
    size_t s = mark();
    std::string text = expect_ident().text;
    while (at_op(".") && peek().kind == Tok::Ident) {
      advance();
      text += "." + advance().text;
    }
    Node* n = node(text.find('.') == std::string::npos ? "SimpleName"
                                                       : "QualifiedName");
    n->label = text; n->has_label = true;
    finish(n, s);
    return n;
  }
  Node* simple_name() { return leaf("SimpleName", expect_ident()); }

  // --------------------------------------------------------- annotations ---
  bool at_annotation() const {
    return at_op("@") && peek().kind == Tok::Ident;
  }
  Node* parse_annotation() {
    DepthGuard dg(*this);
    size_t s = mark();
    expect_op("@");
    Node* name = parse_name_leaf();
    Node* n;
    if (at_op("(")) {
      advance();
      if (at_op(")")) {
        advance();
        n = node("NormalAnnotation");
        n->children.push_back(name);
      } else {
        bool pairs = at_ident() && peek().kind == Tok::Op && peek().text == "=";
        if (pairs) {
          n = node("NormalAnnotation");
          n->children.push_back(name);
          while (true) {
            size_t ps = mark();
            Node* pair = node("MemberValuePair");
            pair->children.push_back(simple_name());
            expect_op("=");
            pair->children.push_back(parse_annotation_value());
            finish(pair, ps);
            n->children.push_back(pair);
            if (at_op(",")) { advance(); continue; }
            break;
          }
        } else {
          n = node("SingleMemberAnnotation");
          n->children.push_back(name);
          n->children.push_back(parse_annotation_value());
        }
        expect_op(")");
      }
    } else {
      n = node("MarkerAnnotation");
      n->children.push_back(name);
    }
    finish(n, s);
    return n;
  }
  Node* parse_annotation_value() {
    if (at_op("{")) {  // array initializer value
      return parse_array_initializer();
    }
    if (at_annotation()) return parse_annotation();
    return parse_expression();
  }

  // modifiers + annotations, interleaved (JDT keeps them in source order)
  void parse_modifiers(std::vector<Node*>& out) {
    while (true) {
      if (at_annotation()) { out.push_back(parse_annotation()); continue; }
      // Java 17 sealed-class modifiers are contextual identifiers: accept
      // `sealed` when what follows keeps reading as a declaration head, and
      // `non-sealed` by fusing its three tokens into one Modifier leaf
      if (cur().kind == Tok::Ident && cur().text == "sealed" &&
          (peek().kind == Tok::Keyword ||
           (peek().kind == Tok::Op && peek().text == "@") ||
           (peek().kind == Tok::Ident &&
            (peek().text == "sealed" || peek().text == "non")))) {
        out.push_back(leaf("Modifier", advance()));
        continue;
      }
      if (cur().kind == Tok::Ident && cur().text == "non" &&
          peek().kind == Tok::Op && peek().text == "-" &&
          peek(2).kind == Tok::Ident && peek(2).text == "sealed") {
        Token fused = cur();
        fused.text = "non-sealed";
        advance(); advance(); advance();
        out.push_back(leaf("Modifier", fused));
        continue;
      }
      if ((cur().kind == Tok::Keyword || cur().kind == Tok::Ident) &&
          is_modifier(cur().text)) {
        // 'default' only a modifier inside interfaces; 'default:' is a switch
        // label — guard on the next token.
        if (cur().text == "default" && peek().kind == Tok::Op &&
            peek().text == ":")
          break;
        if (cur().text == "synchronized" && peek().kind == Tok::Op &&
            peek().text == "(")
          break;  // synchronized-statement, not a modifier
        out.push_back(leaf("Modifier", advance()));
        continue;
      }
      break;
    }
  }

  // --------------------------------------------------------------- types ---
  bool at_type_start() const {
    return at_ident() || (cur().kind == Tok::Keyword && is_primitive(cur().text));
  }

  Node* wrap_simple_type(Node* name_leaf, size_t s) {
    Node* st = node("SimpleType");
    st->children.push_back(name_leaf);
    finish(st, s);
    return st;
  }

  Node* parse_type() {
    DepthGuard dg(*this);
    size_t s = mark();
    Node* base;
    if (cur().kind == Tok::Keyword && is_primitive(cur().text)) {
      base = leaf("PrimitiveType", advance());
    } else {
      base = parse_class_type();
    }
    while (at_op("[") && peek().kind == Tok::Op && peek().text == "]") {
      advance(); advance();
      Node* at = node("ArrayType");
      at->children.push_back(base);
      finish(at, s);
      base = at;
    }
    return base;
  }

  Node* parse_class_type() {
    size_t s = mark();
    if (!at_ident()) err("expected type name");
    // accumulate dotted prefix until a '<' forces a parameterized split
    std::string text = advance().text;
    Node* built = nullptr;  // the type built so far (Simple/Parameterized/Qualified)
    while (true) {
      if (at_op("<") && type_args_ahead()) {
        Node* nm = node(text.find('.') == std::string::npos ? "SimpleName"
                                                            : "QualifiedName");
        nm->label = text; nm->has_label = true;
        finish(nm, s);  // approx span: start..current
        Node* st = built ? qualify(built, nm, s) : wrap_simple_type(nm, s);
        Node* pt = node("ParameterizedType");
        pt->children.push_back(st);
        parse_type_args(pt->children);
        finish(pt, s);
        built = pt;
        text.clear();
        if (at_op(".") && peek().kind == Tok::Ident) {
          advance();
          text = advance().text;
          continue;
        }
        break;
      }
      if (!built && at_op(".") && peek().kind == Tok::Ident) {
        advance();
        text += "." + advance().text;
        continue;
      }
      if (built && !text.empty()) {
        // Outer<T>.Inner (no own type args)
        Node* nm = node("SimpleName");
        nm->label = text; nm->has_label = true;
        finish(nm, s);
        built = qualify(built, nm, s);
        text.clear();
        if (at_op(".") && peek().kind == Tok::Ident) {
          advance();
          text = advance().text;
          continue;
        }
      }
      break;
    }
    if (!built) {
      Node* nm = node(text.find('.') == std::string::npos ? "SimpleName"
                                                          : "QualifiedName");
      nm->label = text; nm->has_label = true;
      finish(nm, s);
      built = wrap_simple_type(nm, s);
    }
    return built;
  }

  Node* qualify(Node* qualifier_type, Node* name, size_t s) {
    Node* qt = node("QualifiedType");
    qt->children.push_back(qualifier_type);
    qt->children.push_back(name);
    finish(qt, s);
    return qt;
  }

  // Speculation: does a well-formed type-argument list start here?
  bool type_args_ahead() {
    State st = save();
    bool ok = try_skip_type_args();
    restore(st);
    return ok;
  }
  bool try_skip_type_args() {
    try {
      parse_type_args_into_scratch();
      return true;
    } catch (const ParseError&) {
      return false;
    }
  }
  void parse_type_args_into_scratch() {
    std::vector<Node*> scratch;
    parse_type_args(scratch);
  }
  void parse_type_args(std::vector<Node*>& out) {
    expect_op("<");
    if (at_op(">")) { advance(); return; }  // diamond
    // Diamond whose '>' was lexed into the enclosing list's closer ('<>>'):
    // split the '>>', consuming one '>' and leaving one for the outer list.
    if (cur().kind == Tok::Op && cur().text == ">>") { expect_gt(); return; }
    while (true) {
      if (at_op("?")) {
        size_t ws = mark();
        advance();
        Node* w = node("WildcardType");
        if (at_kw("extends") || at_kw("super")) {
          advance();
          w->children.push_back(parse_type());
        }
        finish(w, ws);
        out.push_back(w);
      } else {
        out.push_back(parse_type());
      }
      if (at_op(",")) { advance(); continue; }
      break;
    }
    expect_gt();
  }

  // ---------------------------------------------------------- type decls ---
  Node* parse_package() {
    size_t s = mark();
    expect_kw("package");
    Node* n = node("PackageDeclaration");
    n->children.push_back(parse_name_leaf());
    if (at_op(";")) advance();
    finish(n, s);
    return n;
  }

  Node* parse_import() {
    size_t s = mark();
    expect_kw("import");
    if (at_kw("static")) advance();
    Node* n = node("ImportDeclaration");
    n->children.push_back(parse_name_leaf());
    if (at_op(".") && peek().kind == Tok::Op && peek().text == "*") {
      advance(); advance();
    }
    if (at_op(";")) advance();
    finish(n, s);
    return n;
  }

  Node* parse_type_declaration() {
    size_t s = mark();
    std::vector<Node*> mods;
    parse_modifiers(mods);
    if (at_kw("class") || at_kw("interface"))
      return parse_class_or_interface(mods, s);
    if (at_kw("enum")) return parse_enum(mods, s);
    if (at_record()) return parse_record(mods, s);
    if (at_op("@") && peek().kind == Tok::Keyword && peek().text == "interface")
      return parse_annotation_type(mods, s);
    err("expected type declaration");
  }

  // 'record' is a contextual keyword (Java 16): a declaration only when
  // followed by a name and its component list's '(' (or '<' type params)
  bool at_record() const {
    return cur().kind == Tok::Ident && cur().text == "record" &&
           peek().kind == Tok::Ident &&
           peek(2).kind == Tok::Op &&
           (peek(2).text == "(" || peek(2).text == "<");
  }

  Node* parse_record(std::vector<Node*>& mods, size_t s) {
    DepthGuard dg(*this);
    advance();  // 'record'
    Node* n = node("RecordDeclaration");
    n->children = mods;
    n->children.push_back(simple_name());
    if (at_op("<")) parse_type_params(n->children);
    expect_op("(");
    while (!at_op(")")) {
      if (at_end()) err("unterminated record components");
      // components share the full parameter grammar (annotations, varargs,
      // trailing [])
      n->children.push_back(parse_param());
      if (at_op(",")) { advance(); continue; }
      break;
    }
    expect_op(")");
    if (at_kw("implements")) {
      advance();
      n->children.push_back(parse_type());
      while (at_op(",")) { advance(); n->children.push_back(parse_type()); }
    }
    parse_class_body(n->children);
    finish(n, s);
    return n;
  }

  Node* parse_class_or_interface(std::vector<Node*>& mods, size_t s) {
    DepthGuard dg(*this);
    advance();  // class|interface
    Node* n = node("TypeDeclaration");
    n->children = mods;
    n->children.push_back(simple_name());
    if (at_op("<")) parse_type_params(n->children);
    if (at_kw("extends")) {
      advance();
      n->children.push_back(parse_type());
      while (at_op(",")) { advance(); n->children.push_back(parse_type()); }
    }
    if (at_kw("implements")) {
      advance();
      n->children.push_back(parse_type());
      while (at_op(",")) { advance(); n->children.push_back(parse_type()); }
    }
    // Java 17 permits clause (contextual keyword: only '{' may follow the
    // heritage clauses, so a bare identifier here is unambiguous)
    if (cur().kind == Tok::Ident && cur().text == "permits") {
      advance();
      n->children.push_back(parse_type());
      while (at_op(",")) { advance(); n->children.push_back(parse_type()); }
    }
    parse_class_body(n->children);
    finish(n, s);
    return n;
  }

  void parse_type_params(std::vector<Node*>& out) {
    expect_op("<");
    while (true) {
      size_t s = mark();
      while (at_annotation()) parse_annotation();  // drop on type params
      Node* tp = node("TypeParameter");
      tp->children.push_back(simple_name());
      if (at_kw("extends")) {
        advance();
        tp->children.push_back(parse_type());
        while (at_op("&")) { advance(); tp->children.push_back(parse_type()); }
      }
      finish(tp, s);
      out.push_back(tp);
      if (at_op(",")) { advance(); continue; }
      break;
    }
    expect_gt();
  }

  void parse_class_body(std::vector<Node*>& out) {
    expect_op("{");
    while (!at_op("}")) {
      if (at_end()) err("unterminated class body");
      if (at_op(";")) { advance(); continue; }
      out.push_back(parse_member());
    }
    advance();
  }

  Node* parse_member() {
    size_t s = mark();
    std::vector<Node*> mods;
    parse_modifiers(mods);
    if (at_kw("class") || at_kw("interface"))
      return parse_class_or_interface(mods, s);
    if (at_kw("enum")) return parse_enum(mods, s);
    if (at_record()) return parse_record(mods, s);
    if (at_op("@") && peek().kind == Tok::Keyword && peek().text == "interface")
      return parse_annotation_type(mods, s);
    // record compact constructor: Ident '{' occurs for no other member form
    if (at_ident() && peek().kind == Tok::Op && peek().text == "{") {
      Node* n = node("MethodDeclaration");
      n->children = mods;
      n->children.push_back(simple_name());
      n->children.push_back(parse_block());
      finish(n, s);
      return n;
    }
    if (at_op("{")) {  // initializer block (mods may hold 'static')
      Node* n = node("Initializer");
      n->children = mods;
      n->children.push_back(parse_block());
      finish(n, s);
      return n;
    }
    std::vector<Node*> tparams;
    if (at_op("<")) parse_type_params(tparams);
    // constructor: Ident '('
    if (at_ident() && peek().kind == Tok::Op && peek().text == "(") {
      Node* n = node("MethodDeclaration");
      n->children = mods;
      for (Node* tp : tparams) n->children.push_back(tp);
      n->children.push_back(simple_name());
      parse_method_rest(n);
      finish(n, s);
      return n;
    }
    Node* type = parse_type();
    Token name = expect_ident();
    if (at_op("(")) {
      Node* n = node("MethodDeclaration");
      n->children = mods;
      for (Node* tp : tparams) n->children.push_back(tp);
      n->children.push_back(type);
      n->children.push_back(leaf("SimpleName", name));
      parse_method_rest(n);
      // annotation-type member: `type name() default v;`
      finish(n, s);
      return n;
    }
    // field
    Node* n = node("FieldDeclaration");
    n->children = mods;
    n->children.push_back(type);
    parse_fragments(n->children, name);
    expect_op(";");
    finish(n, s);
    return n;
  }

  void parse_method_rest(Node* n) {
    expect_op("(");
    if (!at_op(")")) {
      while (true) {
        n->children.push_back(parse_param());
        if (at_op(",")) { advance(); continue; }
        break;
      }
    }
    expect_op(")");
    while (at_op("[") && peek().kind == Tok::Op && peek().text == "]") {
      advance(); advance();  // legacy `int foo()[]`
    }
    if (at_kw("throws")) {
      advance();
      while (true) {
        size_t ts = mark();
        Node* name = parse_name_leaf();
        n->children.push_back(wrap_simple_type(name, ts));
        if (at_op(",")) { advance(); continue; }
        break;
      }
    }
    if (at_kw("default")) {  // annotation member default
      advance();
      n->children.push_back(parse_annotation_value());
    }
    if (at_op("{")) {
      n->children.push_back(parse_block());
    } else {
      expect_op(";");
    }
  }

  Node* parse_param() {
    size_t s = mark();
    Node* n = node("SingleVariableDeclaration");
    parse_modifiers(n->children);
    n->children.push_back(parse_type());
    if (at_op("...")) advance();  // varargs
    n->children.push_back(simple_name());
    while (at_op("[") && peek().kind == Tok::Op && peek().text == "]") {
      advance(); advance();
    }
    finish(n, s);
    return n;
  }

  void parse_fragments(std::vector<Node*>& out, Token first_name) {
    Token name = first_name;
    while (true) {
      Node* frag = node("VariableDeclarationFragment");
      Node* nm = leaf("SimpleName", name);
      frag->children.push_back(nm);
      frag->pos = nm->pos;
      while (at_op("[") && peek().kind == Tok::Op && peek().text == "]") {
        advance(); advance();
      }
      if (at_op("=")) {
        advance();
        frag->children.push_back(at_op("{") ? parse_array_initializer()
                                            : parse_expression());
      }
      const Token& last = toks_[p_ - 1];
      frag->length = last.pos + static_cast<int>(last.text.size()) - frag->pos;
      out.push_back(frag);
      if (at_op(",")) {
        advance();
        name = expect_ident();
        continue;
      }
      break;
    }
  }

  Node* parse_enum(std::vector<Node*>& mods, size_t s) {
    DepthGuard dg(*this);
    expect_kw("enum");
    Node* n = node("EnumDeclaration");
    n->children = mods;
    n->children.push_back(simple_name());
    if (at_kw("implements")) {
      advance();
      n->children.push_back(parse_type());
      while (at_op(",")) { advance(); n->children.push_back(parse_type()); }
    }
    expect_op("{");
    // constants
    while (!at_op("}") && !at_op(";")) {
      size_t cs = mark();
      Node* c = node("EnumConstantDeclaration");
      while (at_annotation()) c->children.push_back(parse_annotation());
      c->children.push_back(simple_name());
      if (at_op("(")) {
        advance();
        if (!at_op(")")) {
          while (true) {
            c->children.push_back(parse_expression());
            if (at_op(",")) { advance(); continue; }
            break;
          }
        }
        expect_op(")");
      }
      if (at_op("{")) {
        size_t as = mark();
        Node* anon = node("AnonymousClassDeclaration");
        parse_class_body(anon->children);
        finish(anon, as);
        c->children.push_back(anon);
      }
      finish(c, cs);
      n->children.push_back(c);
      if (at_op(",")) { advance(); continue; }
      break;
    }
    if (at_op(";")) {
      advance();
      while (!at_op("}")) {
        if (at_end()) err("unterminated enum body");
        if (at_op(";")) { advance(); continue; }
        n->children.push_back(parse_member());
      }
    }
    expect_op("}");
    finish(n, s);
    return n;
  }

  Node* parse_annotation_type(std::vector<Node*>& mods, size_t s) {
    expect_op("@");
    expect_kw("interface");
    Node* n = node("AnnotationTypeDeclaration");
    n->children = mods;
    n->children.push_back(simple_name());
    expect_op("{");
    while (!at_op("}")) {
      if (at_end()) err("unterminated annotation type body");
      if (at_op(";")) { advance(); continue; }
      size_t ms = mark();
      std::vector<Node*> mmods;
      parse_modifiers(mmods);
      if (at_kw("class") || at_kw("interface")) {
        n->children.push_back(parse_class_or_interface(mmods, ms));
        continue;
      }
      Node* type = parse_type();
      Token name = expect_ident();
      if (at_op("(")) {
        Node* m = node("AnnotationTypeMemberDeclaration");
        m->children = mmods;
        m->children.push_back(type);
        m->children.push_back(leaf("SimpleName", name));
        expect_op("(");
        expect_op(")");
        if (at_kw("default")) {
          advance();
          m->children.push_back(parse_annotation_value());
        }
        expect_op(";");
        finish(m, ms);
        n->children.push_back(m);
      } else {
        Node* f = node("FieldDeclaration");
        f->children = mmods;
        f->children.push_back(type);
        parse_fragments(f->children, name);
        expect_op(";");
        finish(f, ms);
        n->children.push_back(f);
      }
    }
    advance();
    finish(n, s);
    return n;
  }

  // ---------------------------------------------------------- statements ---
  Node* parse_block() {
    size_t s = mark();
    expect_op("{");
    Node* n = node("Block");
    while (!at_op("}")) {
      if (at_end()) err("unterminated block");
      n->children.push_back(parse_statement());
    }
    advance();
    finish(n, s);
    return n;
  }

  Node* parse_statement() {
    DepthGuard dg(*this);
    size_t s = mark();
    if (at_op("{")) return parse_block();
    if (at_op(";")) { advance(); Node* n = node("EmptyStatement"); finish(n, s); return n; }
    if (at_kw("if")) {
      advance();
      Node* n = node("IfStatement");
      expect_op("(");
      n->children.push_back(parse_expression());
      expect_op(")");
      n->children.push_back(parse_statement());
      if (at_kw("else")) {
        advance();
        n->children.push_back(parse_statement());
      }
      finish(n, s);
      return n;
    }
    if (at_kw("while")) {
      advance();
      Node* n = node("WhileStatement");
      expect_op("(");
      n->children.push_back(parse_expression());
      expect_op(")");
      n->children.push_back(parse_statement());
      finish(n, s);
      return n;
    }
    if (at_kw("do")) {
      advance();
      Node* n = node("DoStatement");
      n->children.push_back(parse_statement());
      expect_kw("while");
      expect_op("(");
      n->children.push_back(parse_expression());
      expect_op(")");
      if (at_op(";")) advance();
      finish(n, s);
      return n;
    }
    if (at_kw("for")) return parse_for(s);
    if (at_kw("switch")) return parse_switch(s);
    if (at_kw("try")) return parse_try(s);
    if (at_kw("return")) {
      advance();
      Node* n = node("ReturnStatement");
      if (!at_op(";")) n->children.push_back(parse_expression());
      expect_op(";");
      finish(n, s);
      return n;
    }
    if (at_kw("throw")) {
      advance();
      Node* n = node("ThrowStatement");
      n->children.push_back(parse_expression());
      expect_op(";");
      finish(n, s);
      return n;
    }
    if (at_kw("break") || at_kw("continue")) {
      bool brk = cur().text == "break";
      advance();
      Node* n = node(brk ? "BreakStatement" : "ContinueStatement");
      if (at_ident()) n->children.push_back(simple_name());
      expect_op(";");
      finish(n, s);
      return n;
    }
    if (at_kw("synchronized")) {
      advance();
      Node* n = node("SynchronizedStatement");
      expect_op("(");
      n->children.push_back(parse_expression());
      expect_op(")");
      n->children.push_back(parse_block());
      finish(n, s);
      return n;
    }
    if (at_kw("assert")) {
      advance();
      Node* n = node("AssertStatement");
      n->children.push_back(parse_expression());
      if (at_op(":")) {
        advance();
        n->children.push_back(parse_expression());
      }
      expect_op(";");
      finish(n, s);
      return n;
    }
    if (at_kw("class") || at_kw("interface") || at_kw("enum")) {
      Node* n = node("TypeDeclarationStatement");
      std::vector<Node*> nomods;
      if (at_kw("enum")) n->children.push_back(parse_enum(nomods, s));
      else n->children.push_back(parse_class_or_interface(nomods, s));
      finish(n, s);
      return n;
    }
    // yield statement (contextual keyword, Java 14): inside a switch
    // EXPRESSION body a statement starting with 'yield' is always the
    // yield statement (JLS 14.21 — assigning to a variable named yield
    // there requires qualification); in switch STATEMENTS this branch is
    // dead and 'yield' remains a plain identifier
    if (switch_expr_depth_ > 0 && at_ident() && cur().text == "yield") {
      advance();
      Node* n = node("YieldStatement");
      n->children.push_back(parse_expression());
      expect_op(";");
      finish(n, s);
      return n;
    }
    // labeled statement: Ident ':' stmt
    if (at_ident() && peek().kind == Tok::Op && peek().text == ":" &&
        !(peek(2).kind == Tok::Op && peek(2).text == ":")) {
      Node* n = node("LabeledStatement");
      n->children.push_back(simple_name());
      advance();  // ':'
      n->children.push_back(parse_statement());
      finish(n, s);
      return n;
    }
    // modifier/annotation-led local declaration, or class decl with mods
    if (at_annotation() ||
        ((cur().kind == Tok::Keyword || cur().kind == Tok::Ident) &&
         is_modifier(cur().text) &&
         !(cur().text == "synchronized"))) {
      std::vector<Node*> mods;
      parse_modifiers(mods);
      if (at_kw("class") || at_kw("interface") || at_kw("enum")) {
        Node* n = node("TypeDeclarationStatement");
        if (at_kw("enum")) n->children.push_back(parse_enum(mods, s));
        else n->children.push_back(parse_class_or_interface(mods, s));
        finish(n, s);
        return n;
      }
      Node* n = node("VariableDeclarationStatement");
      n->children = mods;
      n->children.push_back(parse_type());
      parse_fragments(n->children, expect_ident());
      expect_op(";");
      finish(n, s);
      return n;
    }
    // local variable declaration vs expression statement — speculative
    if (at_type_start()) {
      State st = save();
      try {
        Node* type = parse_type();
        if (at_ident()) {
          Token name = advance();
          if (at_op("=") || at_op(";") || at_op(",") ||
              (at_op("[") && peek().kind == Tok::Op && peek().text == "]")) {
            Node* n = node("VariableDeclarationStatement");
            n->children.push_back(type);
            parse_fragments(n->children, name);
            expect_op(";");
            finish(n, s);
            return n;
          }
        }
        restore(st);
      } catch (const ParseError&) {
        restore(st);
      }
    }
    // expression statement
    Node* n = node("ExpressionStatement");
    n->children.push_back(parse_expression());
    expect_op(";");
    finish(n, s);
    return n;
  }

  Node* parse_for(size_t s) {
    expect_kw("for");
    expect_op("(");
    // enhanced for: [mods] Type Ident ':' — speculative
    State st = save();
    try {
      std::vector<Node*> mods;
      parse_modifiers(mods);
      if (at_type_start()) {
        size_t ps = mark();
        Node* type = parse_type();
        if (at_ident()) {
          Token name = advance();
          if (at_op(":")) {
            advance();
            Node* n = node("EnhancedForStatement");
            Node* param = node("SingleVariableDeclaration");
            param->children = mods;
            param->children.push_back(type);
            param->children.push_back(leaf("SimpleName", name));
            finish(param, mods.empty() ? ps : st.p);
            n->children.push_back(param);
            n->children.push_back(parse_expression());
            expect_op(")");
            n->children.push_back(parse_statement());
            finish(n, s);
            return n;
          }
        }
      }
      restore(st);
    } catch (const ParseError&) {
      restore(st);
    }
    Node* n = node("ForStatement");
    if (!at_op(";")) {
      // init: declaration (VariableDeclarationExpression) or expression list
      State st2 = save();
      bool decl = false;
      try {
        size_t ds = mark();
        std::vector<Node*> mods;
        parse_modifiers(mods);
        if (at_type_start()) {
          Node* type = parse_type();
          if (at_ident()) {
            Token name = advance();
            if (at_op("=") || at_op(";") || at_op(",")) {
              Node* vde = node("VariableDeclarationExpression");
              vde->children = mods;
              vde->children.push_back(type);
              parse_fragments(vde->children, name);
              finish(vde, ds);
              n->children.push_back(vde);
              decl = true;
            }
          }
        }
        if (!decl) restore(st2);
      } catch (const ParseError&) {
        restore(st2);
      }
      if (!decl) {
        n->children.push_back(parse_expression());
        while (at_op(",")) { advance(); n->children.push_back(parse_expression()); }
      }
    }
    expect_op(";");
    if (!at_op(";")) n->children.push_back(parse_expression());
    expect_op(";");
    if (!at_op(")")) {
      n->children.push_back(parse_expression());
      while (at_op(",")) { advance(); n->children.push_back(parse_expression()); }
    }
    expect_op(")");
    n->children.push_back(parse_statement());
    finish(n, s);
    return n;
  }

  Node* parse_switch(size_t s) {
    expect_kw("switch");
    Node* n = node("SwitchStatement");
    expect_op("(");
    n->children.push_back(parse_expression());
    expect_op(")");
    parse_switch_block(n, /*is_expr=*/false);
    finish(n, s);
    return n;
  }

  // Shared by SwitchStatement and SwitchExpression: classic `case X:` arms,
  // Java 14 `case A, B -> body` arms (body = expression ';' | block |
  // throw). Yield statements are recognized only under is_expr (JLS 14.21:
  // yield exists only in switch-expression bodies; javac parses any
  // statement there starting with 'yield' as a YieldStatement, while in a
  // switch STATEMENT 'yield' is an ordinary identifier).
  void parse_switch_block(Node* n, bool is_expr) {
    expect_op("{");
    SwitchExprGuard guard(*this, is_expr);
    while (!at_op("}")) {
      if (at_end()) err("unterminated switch");
      if (at_kw("case") || at_kw("default")) {
        size_t cs = mark();
        Node* c = node("SwitchCase");
        if (cur().text == "case") {
          advance();
          c->children.push_back(parse_expression());
          while (at_op(",")) {
            advance();
            c->children.push_back(parse_expression());
          }
        } else {
          advance();
        }
        if (at_op("->")) {
          advance();
          finish(c, cs);
          n->children.push_back(c);
          if (at_op("{")) {
            n->children.push_back(parse_block());
          } else if (at_kw("throw")) {
            n->children.push_back(parse_statement());
          } else {
            size_t es = mark();
            Node* st = node("ExpressionStatement");
            st->children.push_back(parse_expression());
            expect_op(";");
            finish(st, es);
            n->children.push_back(st);
          }
        } else {
          expect_op(":");
          finish(c, cs);
          n->children.push_back(c);
        }
      } else {
        n->children.push_back(parse_statement());
      }
    }
    advance();
  }

  Node* parse_try(size_t s) {
    expect_kw("try");
    Node* n = node("TryStatement");
    if (at_op("(")) {  // try-with-resources
      advance();
      while (!at_op(")")) {
        size_t rs = mark();
        std::vector<Node*> mods;
        parse_modifiers(mods);
        Node* vde = node("VariableDeclarationExpression");
        vde->children = mods;
        vde->children.push_back(parse_type());
        parse_fragments(vde->children, expect_ident());
        finish(vde, rs);
        n->children.push_back(vde);
        if (at_op(";")) { advance(); continue; }
        break;
      }
      expect_op(")");
    }
    n->children.push_back(parse_block());
    while (at_kw("catch")) {
      size_t cs = mark();
      advance();
      Node* cc = node("CatchClause");
      expect_op("(");
      size_t vs = mark();
      Node* param = node("SingleVariableDeclaration");
      parse_modifiers(param->children);
      Node* first = parse_type();
      if (at_op("|")) {
        size_t us = vs;
        Node* ut = node("UnionType");
        ut->children.push_back(first);
        while (at_op("|")) {
          advance();
          ut->children.push_back(parse_type());
        }
        finish(ut, us);
        first = ut;
      }
      param->children.push_back(first);
      param->children.push_back(simple_name());
      finish(param, vs);
      cc->children.push_back(param);
      expect_op(")");
      cc->children.push_back(parse_block());
      finish(cc, cs);
      n->children.push_back(cc);
    }
    if (at_kw("finally")) {
      advance();
      n->children.push_back(parse_block());
    }
    finish(n, s);
    return n;
  }

  // --------------------------------------------------------- expressions ---
  Node* parse_expression() { return parse_assignment(); }

  bool at_assign_op() const {
    if (cur().kind != Tok::Op) return false;
    const std::string& t = cur().text;
    return t == "=" || t == "+=" || t == "-=" || t == "*=" || t == "/=" ||
           t == "%=" || t == "&=" || t == "|=" || t == "^=" || t == "<<=" ||
           t == ">>=" || t == ">>>=";
  }

  Node* parse_assignment() {
    DepthGuard dg(*this);
    size_t s = mark();
    Node* lhs = parse_conditional();
    if (at_assign_op()) {
      std::string op = advance().text;
      Node* n = node("Assignment");
      n->label = op; n->has_label = true;
      n->children.push_back(lhs);
      n->children.push_back(at_op("{") ? parse_array_initializer()
                                       : parse_assignment());
      finish(n, s);
      return n;
    }
    return lhs;
  }

  Node* parse_conditional() {
    DepthGuard dg(*this);
    size_t s = mark();
    Node* c = parse_binary(0);
    if (at_op("?")) {
      advance();
      Node* n = node("ConditionalExpression");
      n->children.push_back(c);
      n->children.push_back(parse_expression());
      expect_op(":");
      n->children.push_back(parse_conditional());
      finish(n, s);
      return n;
    }
    return c;
  }

  // precedence levels, lowest first
  int binop_level(const std::string& t) const {
    if (t == "||") return 1;
    if (t == "&&") return 2;
    if (t == "|") return 3;
    if (t == "^") return 4;
    if (t == "&") return 5;
    if (t == "==" || t == "!=") return 6;
    if (t == "<" || t == ">" || t == "<=" || t == ">=") return 7;  // + instanceof
    if (t == "<<" || t == ">>" || t == ">>>") return 8;
    if (t == "+" || t == "-") return 9;
    if (t == "*" || t == "/" || t == "%") return 10;
    return -1;
  }

  Node* parse_binary(int min_level) {
    size_t s = mark();
    Node* lhs = parse_unary();
    while (true) {
      if (at_kw("instanceof") && min_level <= 7) {
        advance();
        Node* n = node("InstanceofExpression");
        n->children.push_back(lhs);
        n->children.push_back(parse_type());
        // Java 16 pattern variable: `o instanceof String s` — a bare
        // identifier can follow the type in no other instanceof form
        if (at_ident()) n->children.push_back(simple_name());
        finish(n, s);
        lhs = n;
        continue;
      }
      if (cur().kind != Tok::Op) break;
      int lvl = binop_level(cur().text);
      if (lvl < 0 || lvl < min_level) break;
      // '<' ambiguity with generics is resolved upstream (types are only
      // parsed speculatively); here '<' is always an operator.
      std::string op = advance().text;
      Node* rhs = parse_binary(lvl + 1);
      // JDT flattens same-operator chains into one InfixExpression with
      // extended operands.
      if (lhs->typeLabel == "InfixExpression" && lhs->has_label &&
          lhs->label == op) {
        lhs->children.push_back(rhs);
        const Token& last = toks_[p_ - 1];
        lhs->length = last.pos + static_cast<int>(last.text.size()) - lhs->pos;
      } else {
        Node* n = node("InfixExpression");
        n->label = op; n->has_label = true;
        n->children.push_back(lhs);
        n->children.push_back(rhs);
        finish(n, s);
        lhs = n;
      }
    }
    return lhs;
  }

  Node* parse_unary() {
    DepthGuard dg(*this);
    size_t s = mark();
    if (cur().kind == Tok::Op &&
        (cur().text == "+" || cur().text == "-" || cur().text == "!" ||
         cur().text == "~" || cur().text == "++" || cur().text == "--")) {
      std::string op = advance().text;
      Node* n = node("PrefixExpression");
      n->label = op; n->has_label = true;
      n->children.push_back(parse_unary());
      finish(n, s);
      return n;
    }
    // cast: '(' Type ')' operand
    if (at_op("(")) {
      State st = save();
      try {
        advance();
        Node* type = parse_type();
        if (at_op(")")) {
          advance();
          bool operand_next =
              at_ident() || cur().kind == Tok::Number ||
              cur().kind == Tok::String || cur().kind == Tok::Char ||
              at_op("(") || at_op("!") || at_op("~") ||
              at_kw("this") || at_kw("super") || at_kw("new") ||
              at_kw("true") || at_kw("false") || at_kw("null") ||
              (type->typeLabel == "PrimitiveType" &&
               (at_op("+") || at_op("-")));
          if (operand_next) {
            Node* n = node("CastExpression");
            n->children.push_back(type);
            n->children.push_back(parse_unary());
            finish(n, s);
            return n;
          }
        }
        restore(st);
      } catch (const ParseError&) {
        restore(st);
      }
    }
    return parse_postfix();
  }

  Node* parse_postfix() {
    size_t s = mark();
    Node* e = parse_primary();
    // Postfix chains (a.b().c()[i]...) deepen the tree ITERATIVELY, so the
    // recursive DepthGuard never sees them — bound the wrapping links too, or
    // a pathological chain re-creates the stack-overflow the guard exists to
    // prevent (recursive finalize/serialize/destruct all walk this spine).
    // Only node-WRAPPING branches call bump(): the QualifiedName merge folds
    // arbitrarily many '.name's into one flat leaf and must stay unbounded.
    int links = 0;
    auto bump = [&] {
      if (depth_ + ++links >= kMaxDepth) err("postfix chain too deep");
    };
    while (true) {
      if (at_op(".")) {
        // method invocation / field access / qualified this / inner new /
        // .class handled at primary for type names
        if (peek().kind == Tok::Ident) {
          bool call = peek(2).kind == Tok::Op && peek(2).text == "(";
          if (call) {
            bump();
            advance();  // '.'
            Node* n = node("MethodInvocation");
            n->children.push_back(e);
            n->children.push_back(simple_name());
            parse_args(n->children);
            finish(n, s);
            e = n;
            continue;
          }
          // plain field access; extend Name leaves into QualifiedName
          advance();  // '.'
          Token name = advance();
          if ((e->typeLabel == "SimpleName" || e->typeLabel == "QualifiedName") &&
              e->children.empty()) {
            e->typeLabel = "QualifiedName";
            e->label += "." + name.text;
            e->length = name.pos + static_cast<int>(name.text.size()) - e->pos;
          } else {
            bump();
            Node* n = node("FieldAccess");
            n->children.push_back(e);
            n->children.push_back(leaf("SimpleName", name));
            finish(n, s);
            e = n;
          }
          continue;
        }
        if (peek().kind == Tok::Op && peek().text == "<") {
          // expr.<T>m(...)
          State st = save();
          try {
            bump();
            advance();  // '.'
            std::vector<Node*> targs;
            parse_type_args(targs);
            Node* n = node("MethodInvocation");
            n->children.push_back(e);
            for (Node* a : targs) n->children.push_back(a);
            n->children.push_back(simple_name());
            parse_args(n->children);
            finish(n, s);
            e = n;
            continue;
          } catch (const ParseError&) {
            restore(st);
          }
        }
        if (peek().kind == Tok::Keyword && peek().text == "this") {
          bump();
          advance(); advance();
          Node* n = node("ThisExpression");  // qualified this; no label
          n->children.push_back(e);
          finish(n, s);
          e = n;
          continue;
        }
        if (peek().kind == Tok::Keyword && peek().text == "new") {
          bump();
          advance();
          Node* n = parse_new(s, e);
          e = n;
          continue;
        }
        if (peek().kind == Tok::Keyword && peek().text == "class") {
          // Name.class
          bump();
          advance(); advance();
          Node* tl = node("TypeLiteral");
          if ((e->typeLabel == "SimpleName" || e->typeLabel == "QualifiedName") &&
              e->children.empty()) {
            Node* st = node("SimpleType");
            st->children.push_back(e);
            st->pos = e->pos; st->length = e->length;
            tl->children.push_back(st);
          } else {
            tl->children.push_back(e);
          }
          finish(tl, s);
          e = tl;
          continue;
        }
        if (peek().kind == Tok::Keyword && peek().text == "super") {
          bump();
          // Outer.super.m(...) / Outer.super.x — keep the qualifier as the
          // first child (JDT shape) so its source token stays in the tree.
          advance(); advance();
          expect_op(".");
          Node* name = simple_name();
          Node* n;
          if (at_op("(")) {
            n = node("SuperMethodInvocation");
            n->children.push_back(e);
            n->children.push_back(name);
            parse_args(n->children);
          } else {
            n = node("SuperFieldAccess");
            n->children.push_back(e);
            n->children.push_back(name);
          }
          finish(n, s);
          e = n;
          continue;
        }
        err("unsupported '.' suffix");
      }
      if (at_op("[")) {
        bump();
        advance();
        Node* n = node("ArrayAccess");
        n->children.push_back(e);
        n->children.push_back(parse_expression());
        expect_op("]");
        finish(n, s);
        e = n;
        continue;
      }
      if (at_op("++") || at_op("--")) {
        bump();
        std::string op = advance().text;
        Node* n = node("PostfixExpression");
        n->label = op; n->has_label = true;
        n->children.push_back(e);
        finish(n, s);
        e = n;
        continue;
      }
      if (at_op("::")) {
        bump();
        advance();
        Node* n = node("ExpressionMethodReference");
        n->children.push_back(e);
        if (at_kw("new")) {
          advance();
          Node* nm = node("SimpleName");
          nm->label = "new"; nm->has_label = true;
          nm->pos = toks_[p_ - 1].pos; nm->length = 3;
          n->children.push_back(nm);
        } else {
          n->children.push_back(simple_name());
        }
        finish(n, s);
        e = n;
        continue;
      }
      break;
    }
    return e;
  }

  void parse_args(std::vector<Node*>& out) {
    expect_op("(");
    if (!at_op(")")) {
      while (true) {
        out.push_back(parse_expression());
        if (at_op(",")) { advance(); continue; }
        break;
      }
    }
    expect_op(")");
  }

  Node* parse_array_initializer() {
    DepthGuard dg(*this);
    size_t s = mark();
    expect_op("{");
    Node* n = node("ArrayInitializer");
    while (!at_op("}")) {
      n->children.push_back(at_op("{") ? parse_array_initializer()
                                       : parse_expression());
      if (at_op(",")) { advance(); continue; }
      break;
    }
    expect_op("}");
    finish(n, s);
    return n;
  }

  Node* parse_new(size_t s, Node* outer) {
    expect_kw("new");
    // element type WITHOUT trailing '[]' dims — those belong to the
    // array-creation syntax here (`new int[] {...}`, `new Foo[n]`), so using
    // parse_type() would swallow them and break the '[' dispatch below
    Node* type;
    if (cur().kind == Tok::Keyword && is_primitive(cur().text)) {
      type = leaf("PrimitiveType", advance());
    } else {
      type = parse_class_type();
    }
    if (at_op("[")) {
      // array creation; rebuild element/dims
      Node* n = node("ArrayCreation");
      Node* at = node("ArrayType");
      at->children.push_back(type);
      at->pos = type->pos;
      int ndims = 0;
      std::vector<Node*> dims;
      while (at_op("[")) {
        advance();
        if (!at_op("]")) dims.push_back(parse_expression());
        expect_op("]");
        ++ndims;
      }
      const Token& last = toks_[p_ - 1];
      at->length = last.pos + static_cast<int>(last.text.size()) - at->pos;
      n->children.push_back(at);
      for (Node* d : dims) n->children.push_back(d);
      if (at_op("{")) n->children.push_back(parse_array_initializer());
      finish(n, s);
      return n;
    }
    Node* n = node("ClassInstanceCreation");
    if (outer) n->children.push_back(outer);
    n->children.push_back(type);
    parse_args(n->children);
    if (at_op("{")) {
      size_t as = mark();
      Node* anon = node("AnonymousClassDeclaration");
      parse_class_body(anon->children);
      finish(anon, as);
      n->children.push_back(anon);
    }
    finish(n, s);
    return n;
  }

  // Lambda: Ident '->' | '(' params ')' '->'
  bool lambda_ahead() {
    if (at_ident() && peek().kind == Tok::Op && peek().text == "->") return true;
    if (!at_op("(")) return false;
    // scan to matching ')'
    int depth = 0;
    size_t i = p_;
    while (i < toks_.size() && toks_[i].kind != Tok::End) {
      const std::string& t = toks_[i].text;
      if (toks_[i].kind == Tok::Op) {
        if (t == "(") ++depth;
        else if (t == ")") {
          --depth;
          if (depth == 0) {
            return i + 1 < toks_.size() && toks_[i + 1].kind == Tok::Op &&
                   toks_[i + 1].text == "->";
          }
        }
      }
      ++i;
    }
    return false;
  }

  Node* parse_lambda() {
    size_t s = mark();
    Node* n = node("LambdaExpression");
    if (at_ident()) {
      size_t fs = mark();
      Node* frag = node("VariableDeclarationFragment");
      frag->children.push_back(simple_name());
      finish(frag, fs);
      n->children.push_back(frag);
    } else {
      expect_op("(");
      while (!at_op(")")) {
        State st = save();
        bool typed = false;
        try {
          size_t ps = mark();
          std::vector<Node*> mods;
          parse_modifiers(mods);
          if (at_type_start()) {
            Node* type = parse_type();
            if (at_ident()) {
              Node* param = node("SingleVariableDeclaration");
              param->children = mods;
              param->children.push_back(type);
              param->children.push_back(simple_name());
              finish(param, ps);
              n->children.push_back(param);
              typed = true;
            }
          }
          if (!typed) restore(st);
        } catch (const ParseError&) {
          restore(st);
        }
        if (!typed) {
          size_t fs = mark();
          Node* frag = node("VariableDeclarationFragment");
          frag->children.push_back(simple_name());
          finish(frag, fs);
          n->children.push_back(frag);
        }
        if (at_op(",")) { advance(); continue; }
        break;
      }
      expect_op(")");
    }
    expect_op("->");
    n->children.push_back(at_op("{") ? parse_block() : parse_expression());
    finish(n, s);
    return n;
  }

  Node* parse_primary() {
    size_t s = mark();
    if (lambda_ahead()) return parse_lambda();
    if (at_kw("switch")) {  // Java 14 switch expression
      advance();
      Node* n = node("SwitchExpression");
      expect_op("(");
      n->children.push_back(parse_expression());
      expect_op(")");
      parse_switch_block(n, /*is_expr=*/true);
      finish(n, s);
      return n;
    }
    if (cur().kind == Tok::Number) return leaf("NumberLiteral", advance());
    if (cur().kind == Tok::String) return leaf("StringLiteral", advance());
    if (cur().kind == Tok::Char) return leaf("CharacterLiteral", advance());
    if (at_kw("true") || at_kw("false")) return leaf("BooleanLiteral", advance());
    if (at_kw("null")) return leaf("NullLiteral", advance(), /*with_label=*/false);
    if (at_kw("this")) {
      Token tk = advance();
      if (at_op("(")) {  // this(...) constructor invocation (expression pos)
        Node* n = node("ConstructorInvocation");
        parse_args(n->children);
        finish(n, s);
        return n;
      }
      return leaf("ThisExpression", tk, /*with_label=*/false);
    }
    if (at_kw("super")) {
      Token tk = advance();
      if (at_op("(")) {
        Node* n = node("SuperConstructorInvocation");
        parse_args(n->children);
        finish(n, s);
        return n;
      }
      expect_op(".");
      Token name = expect_ident();
      if (at_op("(")) {
        Node* n = node("SuperMethodInvocation");
        n->children.push_back(leaf("SimpleName", name));
        parse_args(n->children);
        finish(n, s);
        return n;
      }
      Node* n = node("SuperFieldAccess");
      n->children.push_back(leaf("SimpleName", name));
      finish(n, s);
      return n;
    }
    if (at_kw("new")) return parse_new(s, nullptr);
    if (at_op("(")) {
      advance();
      Node* inner = parse_expression();
      expect_op(")");
      Node* n = node("ParenthesizedExpression");
      n->children.push_back(inner);
      finish(n, s);
      return n;
    }
    if (cur().kind == Tok::Keyword && is_primitive(cur().text)) {
      // int.class / int[].class
      Node* type = parse_type();
      expect_op(".");
      expect_kw("class");
      Node* n = node("TypeLiteral");
      n->children.push_back(type);
      finish(n, s);
      return n;
    }
    if (at_ident()) {
      Token name = advance();
      if (at_op("(")) {
        Node* n = node("MethodInvocation");
        n->children.push_back(leaf("SimpleName", name));
        parse_args(n->children);
        finish(n, s);
        return n;
      }
      return leaf("SimpleName", name);
    }
    err("expected expression");
  }
};

}  // namespace

void Tree::finalize() {
  preorder.clear();
  std::function<void(Node*, Node*)> walk = [&](Node* n, Node* parent) {
    n->parent = parent;
    n->id = static_cast<int>(preorder.size());
    preorder.push_back(n);
    n->height = 0;
    n->size = 1;
    uint64_t h = 1469598103934665603ull;
    auto mix = [&h](const std::string& s) {
      for (char c : s) { h ^= static_cast<unsigned char>(c); h *= 1099511628211ull; }
      h ^= 0xff; h *= 1099511628211ull;
    };
    mix(n->typeLabel);
    if (n->has_label) mix(n->label);
    for (Node* c : n->children) {
      walk(c, n);
      n->height = std::max(n->height, c->height + 1);
      n->size += c->size;
      h ^= c->hash + 0x9e3779b97f4a7c15ull + (h << 6) + (h >> 2);
    }
    n->hash = h;
  };
  if (root) walk(root, nullptr);
}

std::unique_ptr<Tree> parse(const std::string& src) {
  Parser p(src);
  return p.run();
}

}  // namespace astdiff
