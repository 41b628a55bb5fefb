// Java tokenizer (maximal-munch). Replaces the reference's use of
// javalang.tokenizer (process_data_ast_parallel.py:48,122): same observable
// role — split fragment text into Java tokens; a LexError makes the caller
// drop the chunk's AST, mirroring the reference's try/except around
// javalang.tokenizer.tokenize.
#include "astdiff.hpp"

#include <array>
#include <cctype>
#include <unordered_set>

namespace astdiff {

namespace {

const std::unordered_set<std::string>& keywords() {
  static const std::unordered_set<std::string> kw = {
      "abstract", "assert",    "boolean",  "break",      "byte",     "case",
      "catch",    "char",      "class",    "const",      "continue", "default",
      "do",       "double",    "else",     "enum",       "extends",  "final",
      "finally",  "float",     "for",      "goto",       "if",       "implements",
      "import",   "instanceof","int",      "interface",  "long",     "native",
      "new",      "package",   "private",  "protected",  "public",   "return",
      "short",    "static",    "strictfp", "super",      "switch",   "synchronized",
      "this",     "throw",     "throws",   "transient",  "try",      "void",
      "volatile", "while",     "true",     "false",      "null"};
  return kw;
}

// Multi-char operators, longest first within each leading char.
const std::array<const char*, 25> MULTI_OPS = {
    ">>>=", ">>>", ">>=", ">>", ">=", "<<=", "<<", "<=", "...", "->",
    "::",   "==",  "!=",  "&&", "&=", "||",  "|=", "++", "+=",  "--",
    "-=",   "*=",  "/=",  "%=", "^="};

bool ident_start(char c) {
  return std::isalpha(static_cast<unsigned char>(c)) || c == '_' || c == '$' ||
         static_cast<unsigned char>(c) >= 0x80;  // UTF-8 continuation-friendly
}
bool ident_part(char c) {
  return ident_start(c) || std::isdigit(static_cast<unsigned char>(c));
}

}  // namespace

std::vector<Token> lex(const std::string& src) {
  std::vector<Token> out;
  const size_t n = src.size();
  size_t i = 0;
  while (i < n) {
    char c = src[i];
    if (std::isspace(static_cast<unsigned char>(c))) {
      ++i;
      continue;
    }
    // comments
    if (c == '/' && i + 1 < n && (src[i + 1] == '/' || src[i + 1] == '*')) {
      if (src[i + 1] == '/') {
        while (i < n && src[i] != '\n') ++i;
      } else {
        size_t j = i + 2;
        while (j + 1 < n && !(src[j] == '*' && src[j + 1] == '/')) ++j;
        if (j + 1 >= n) throw LexError("unterminated block comment");
        i = j + 2;
      }
      continue;
    }
    const int pos = static_cast<int>(i);
    // identifier / keyword
    if (ident_start(c)) {
      size_t j = i + 1;
      while (j < n && ident_part(src[j])) ++j;
      std::string text = src.substr(i, j - i);
      out.push_back({keywords().count(text) ? Tok::Keyword : Tok::Ident,
                     std::move(text), pos});
      i = j;
      continue;
    }
    // number literal (int/float, hex/bin/oct, underscores, suffixes)
    if (std::isdigit(static_cast<unsigned char>(c)) ||
        (c == '.' && i + 1 < n &&
         std::isdigit(static_cast<unsigned char>(src[i + 1])))) {
      size_t j = i;
      bool hex = false;
      if (c == '0' && j + 1 < n && (src[j + 1] == 'x' || src[j + 1] == 'X')) {
        hex = true;
        j += 2;
        while (j < n && (std::isxdigit(static_cast<unsigned char>(src[j])) ||
                         src[j] == '_'))
          ++j;
      } else if (c == '0' && j + 1 < n &&
                 (src[j + 1] == 'b' || src[j + 1] == 'B')) {
        j += 2;
        while (j < n && (src[j] == '0' || src[j] == '1' || src[j] == '_')) ++j;
      } else {
        while (j < n && (std::isdigit(static_cast<unsigned char>(src[j])) ||
                         src[j] == '_'))
          ++j;
        if (j < n && src[j] == '.') {
          ++j;
          while (j < n && (std::isdigit(static_cast<unsigned char>(src[j])) ||
                           src[j] == '_'))
            ++j;
        }
        if (j < n && (src[j] == 'e' || src[j] == 'E')) {
          size_t k = j + 1;
          if (k < n && (src[k] == '+' || src[k] == '-')) ++k;
          if (k < n && std::isdigit(static_cast<unsigned char>(src[k]))) {
            j = k;
            while (j < n && std::isdigit(static_cast<unsigned char>(src[j])))
              ++j;
          }
        }
      }
      if (j < n && (src[j] == 'l' || src[j] == 'L' ||
                    (!hex && (src[j] == 'f' || src[j] == 'F' || src[j] == 'd' ||
                              src[j] == 'D'))))
        ++j;
      out.push_back({Tok::Number, src.substr(i, j - i), pos});
      i = j;
      continue;
    }
    // Java 13+ text block: """ ... """ (may span lines; \ escapes)
    if (c == '"' && i + 2 < n && src[i + 1] == '"' && src[i + 2] == '"') {
      size_t j = i + 3;
      while (j + 2 < n &&
             !(src[j] == '"' && src[j + 1] == '"' && src[j + 2] == '"')) {
        if (src[j] == '\\') ++j;
        ++j;
      }
      if (j + 2 >= n) throw LexError("unterminated text block");
      out.push_back({Tok::String, src.substr(i, j + 3 - i), pos});
      i = j + 3;
      continue;
    }
    // string / char literal
    if (c == '"' || c == '\'') {
      size_t j = i + 1;
      while (j < n && src[j] != c) {
        if (src[j] == '\\') ++j;
        if (src[j] == '\n') throw LexError("newline in literal");
        ++j;
      }
      if (j >= n) throw LexError("unterminated literal");
      out.push_back({c == '"' ? Tok::String : Tok::Char,
                     src.substr(i, j - i + 1), pos});
      i = j + 1;
      continue;
    }
    // multi-char operator (maximal munch)
    bool matched = false;
    for (const char* op : MULTI_OPS) {
      size_t len = std::char_traits<char>::length(op);
      if (src.compare(i, len, op) == 0) {
        out.push_back({Tok::Op, op, pos});
        i += len;
        matched = true;
        break;
      }
    }
    if (matched) continue;
    // single-char operator/separator
    static const std::string singles = "+-*/%=<>!~&|^?:;,.(){}[]@";
    if (singles.find(c) != std::string::npos) {
      out.push_back({Tok::Op, std::string(1, c), pos});
      ++i;
      continue;
    }
    throw LexError("unexpected character at " + std::to_string(i));
  }
  out.push_back({Tok::End, "", static_cast<int>(n)});
  return out;
}

}  // namespace astdiff
