// C API (for ctypes, the in-process fast path) + CLI main (the GumTree
// contract surface: `astdiff parse f.java`, `astdiff diff a.java b.java` —
// drop-in for the reference's `gumtree parse|diff` subprocess calls,
// get_ast_root_action.py:70,124).
#include "astdiff.hpp"

#include <cstring>
#include <fstream>
#include <iostream>
#include <sstream>

namespace {

char* dup_string(const std::string& s) {
  char* out = static_cast<char*>(std::malloc(s.size() + 1));
  if (!out) return nullptr;
  std::memcpy(out, s.c_str(), s.size() + 1);
  return out;
}

}  // namespace

extern "C" {

// Parse Java source -> malloc'd JSON string, or NULL on any parse failure.
char* astdiff_parse(const char* src) {
  try {
    auto tree = astdiff::parse(src);
    return dup_string(astdiff::to_json(*tree));
  } catch (const std::exception&) {
    return nullptr;
  }
}

// Diff two Java sources -> malloc'd action-line text, or NULL on failure.
char* astdiff_diff(const char* src_old, const char* src_new) {
  try {
    auto told = astdiff::parse(src_old);
    auto tnew = astdiff::parse(src_new);
    return dup_string(astdiff::diff_actions(*told, *tnew));
  } catch (const std::exception&) {
    return nullptr;
  }
}

// Tokenize Java source -> malloc'd newline-joined token texts, or NULL.
// (Replaces the reference's javalang.tokenizer calls.)
char* astdiff_tokenize(const char* src) {
  try {
    auto toks = astdiff::lex(src);
    std::ostringstream os;
    for (const auto& t : toks) {
      if (t.kind == astdiff::Tok::End) break;
      os << t.text << "\n";
    }
    return dup_string(os.str());
  } catch (const std::exception&) {
    return nullptr;
  }
}

void astdiff_free(char* p) { std::free(p); }

}  // extern "C"

#ifdef ASTDIFF_MAIN
namespace {
std::string read_file(const char* path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) throw std::runtime_error(std::string("cannot open ") + path);
  std::ostringstream os;
  os << f.rdbuf();
  return os.str();
}
}  // namespace

int main(int argc, char** argv) {
  try {
    if (argc >= 3 && std::string(argv[1]) == "parse") {
      auto tree = astdiff::parse(read_file(argv[2]));
      std::cout << astdiff::to_json(*tree) << "\n";
      return 0;
    }
    if (argc >= 4 && std::string(argv[1]) == "diff") {
      auto told = astdiff::parse(read_file(argv[2]));
      auto tnew = astdiff::parse(read_file(argv[3]));
      std::cout << astdiff::diff_actions(*told, *tnew);
      return 0;
    }
    std::cerr << "usage: astdiff parse <f.java> | astdiff diff <a.java> <b.java>\n";
    return 2;
  } catch (const std::exception& e) {
    std::cerr << "astdiff: " << e.what() << "\n";
    return 1;
  }
}
#endif
