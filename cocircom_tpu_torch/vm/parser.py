"""circom 2.x recursive-descent parser (subset) -> simple AST (tuples).

AST node shapes (tuples, first element = tag):
  expr: ('num', v) ('var', name) ('idx', base, index_expr) ('mem', base, field)
        ('bin', op, l, r) ('un', op, e) ('tern', c, a, b) ('call', name, [args])
  stmt: ('decl_signal', kind, name, dims, tag?) ('decl_var', name, dims, init)
        ('decl_comp', name, dims) ('assign', op, lhs, rhs) ('constraint', l, r)
        ('for', init, cond, step, body) ('while', cond, body)
        ('if', cond, then, els) ('return', e) ('assert', e) ('log', args)
        ('block', [stmts]) ('expr', e) ('subs', lhs, op, rhs)
"""

from __future__ import annotations

from .lexer import Tok, tokenize


class Parser:
    def __init__(self, src: str):
        self.toks = tokenize(src)
        self.i = 0

    def peek(self, k=0) -> Tok:
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self) -> Tok:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, val=None, kind=None) -> Tok:
        t = self.next()
        if val is not None and t.val != val:
            raise SyntaxError(f"expected {val!r}, got {t.val!r} @{t.pos}")
        if kind is not None and t.kind != kind:
            raise SyntaxError(f"expected {kind}, got {t.kind} {t.val!r} @{t.pos}")
        return t

    def accept(self, val) -> bool:
        if self.peek().val == val:
            self.i += 1
            return True
        return False

    # ------------------------------------------------------------ top level

    def parse_file(self):
        includes, templates, functions, main = [], {}, {}, None
        while self.peek().kind != "eof":
            t = self.peek()
            if t.val == "pragma":
                while self.next().val != ";":
                    pass
            elif t.val == "include":
                self.next()
                includes.append(self.expect(kind="str").val[1:-1])
                self.expect(";")
            elif t.val == "template":
                name, params, body = self._template()
                templates[name] = (params, body)
            elif t.val == "function":
                name, params, body = self._template()
                functions[name] = (params, body)
            elif t.val == "component":
                self.next()
                self.expect("main")
                publics = []
                if self.accept("{"):
                    self.expect("public")
                    self.expect("[")
                    while True:
                        publics.append(self.expect(kind="ident").val)
                        if not self.accept(","):
                            break
                    self.expect("]")
                    self.expect("}")
                self.expect("=")
                e = self.expr()
                self.expect(";")
                main = (e, publics)
            else:
                raise SyntaxError(f"unexpected {t.val!r} @{t.pos}")
        return includes, templates, functions, main

    def _template(self):
        self.next()  # template/function
        if self.peek().val == "parallel":
            self.next()
        name = self.expect(kind="ident").val
        self.expect("(")
        params = []
        if self.peek().val != ")":
            while True:
                params.append(self.expect(kind="ident").val)
                if not self.accept(","):
                    break
        self.expect(")")
        body = self.block()
        return name, params, body

    # ------------------------------------------------------------ statements

    def block(self):
        self.expect("{")
        stmts = []
        while not self.accept("}"):
            stmts.append(self.stmt())
        return ("block", stmts)

    def stmt(self):
        t = self.peek()
        if t.val == "{":
            return self.block()
        if t.val == "signal":
            return self._signal_decl()
        if t.val == "var":
            return self._var_decl()
        if t.val == "component":
            self.next()
            name = self.expect(kind="ident").val
            dims = self._dims()
            if self.accept("="):
                rhs = self.expr()
                self.expect(";")
                return ("block", [("decl_comp", name, dims), ("assign", "=", ("var", name), rhs)])
            self.expect(";")
            return ("decl_comp", name, dims)
        if t.val == "for":
            self.next()
            self.expect("(")
            init = self._simple_stmt()
            cond = self.expr()
            self.expect(";")
            step = self._simple_stmt_nosemi()
            self.expect(")")
            body = self.stmt()
            return ("for", init, cond, step, body)
        if t.val == "while":
            self.next()
            self.expect("(")
            cond = self.expr()
            self.expect(")")
            return ("while", cond, self.stmt())
        if t.val == "if":
            self.next()
            self.expect("(")
            cond = self.expr()
            self.expect(")")
            then = self.stmt()
            els = self.stmt() if self.accept("else") else None
            return ("if", cond, then, els)
        if t.val == "return":
            self.next()
            e = self.expr()
            self.expect(";")
            return ("return", e)
        if t.val == "assert":
            self.next()
            self.expect("(")
            e = self.expr()
            self.expect(")")
            self.expect(";")
            return ("assert", e)
        if t.val == "log":
            self.next()
            self.expect("(")
            args = []
            if self.peek().val != ")":
                while True:
                    if self.peek().kind == "str":
                        args.append(("str", self.next().val))
                    else:
                        args.append(self.expr())
                    if not self.accept(","):
                        break
            self.expect(")")
            self.expect(";")
            return ("log", args)
        s = self._simple_stmt()
        return s

    def _signal_decl(self):
        self.next()  # signal
        kind = "intermediate"
        if self.peek().val in ("input", "output"):
            kind = self.next().val
        # optional tags {tag, ...}
        if self.accept("{"):
            while self.next().val != "}":
                pass
        decls = []
        while True:
            name = self.expect(kind="ident").val
            dims = self._dims()
            init = None
            if self.peek().val in ("<==", "<--"):
                op = self.next().val
                init = (op, self.expr())
            decls.append(("decl_signal", kind, name, dims, init))
            if not self.accept(","):
                break
        self.expect(";")
        return ("block", decls) if len(decls) > 1 else decls[0]

    def _var_decl(self):
        self.next()  # var
        decls = []
        while True:
            name = self.expect(kind="ident").val
            dims = self._dims()
            init = None
            if self.accept("="):
                init = self.expr()
            decls.append(("decl_var", name, dims, init))
            if not self.accept(","):
                break
        self.expect(";")
        return ("block", decls) if len(decls) > 1 else decls[0]

    def _dims(self):
        dims = []
        while self.accept("["):
            dims.append(self.expr())
            self.expect("]")
        return dims

    def _simple_stmt(self):
        s = self._simple_stmt_nosemi()
        self.expect(";")
        return s

    def _simple_stmt_nosemi(self):
        # assignment / declaration-free statement (also for-init/step)
        if self.peek().val == "var":
            # var decl without consuming the trailing ';' is awkward; reuse
            self.next()
            name = self.expect(kind="ident").val
            dims = self._dims()
            init = None
            if self.accept("="):
                init = self.expr()
            return ("decl_var", name, dims, init)
        lhs = self.expr()
        t = self.peek().val
        if t in ("=", "<==", "<--") or (
            t.endswith("=") and t[:-1] in ("+", "-", "*", "/", "\\", "%", "**", "<<", ">>", "&", "|", "^")
        ):
            self.next()
            rhs = self.expr()
            return ("assign", t, lhs, rhs)
        if t in ("==>", "-->"):
            self.next()
            rhs = self.expr()  # rhs is the destination
            return ("assign", "<==" if t == "==>" else "<--", rhs, lhs)
        if t == "===":
            self.next()
            rhs = self.expr()
            return ("constraint", lhs, rhs)
        if t == "++":
            self.next()
            return ("assign", "=", lhs, ("bin", "+", lhs, ("num", "1")))
        if t == "--":
            self.next()
            return ("assign", "=", lhs, ("bin", "-", lhs, ("num", "1")))
        return ("expr", lhs)

    # ------------------------------------------------------------ expressions

    def expr(self):
        return self._ternary()

    def _ternary(self):
        c = self._or()
        if self.accept("?"):
            a = self.expr()
            self.expect(":")
            b = self.expr()
            return ("tern", c, a, b)
        return c

    def _bin_level(self, ops, sub):
        e = sub()
        while self.peek().val in ops:
            op = self.next().val
            e = ("bin", op, e, sub())
        return e

    def _or(self):
        return self._bin_level({"||"}, self._and)

    def _and(self):
        return self._bin_level({"&&"}, self._bor)

    def _bor(self):
        return self._bin_level({"|"}, self._bxor)

    def _bxor(self):
        return self._bin_level({"^"}, self._band)

    def _band(self):
        return self._bin_level({"&"}, self._cmp)

    def _cmp(self):
        return self._bin_level({"==", "!=", "<", ">", "<=", ">="}, self._shift)

    def _shift(self):
        return self._bin_level({"<<", ">>"}, self._addsub)

    def _addsub(self):
        return self._bin_level({"+", "-"}, self._muldiv)

    def _muldiv(self):
        return self._bin_level({"*", "/", "\\", "%"}, self._pow)

    def _pow(self):
        e = self._unary()
        if self.peek().val == "**":
            self.next()
            return ("bin", "**", e, self._pow())
        return e

    def _unary(self):
        t = self.peek().val
        if t in ("-", "!", "~"):
            self.next()
            return ("un", t, self._unary())
        return self._postfix()

    def _postfix(self):
        e = self._atom()
        while True:
            t = self.peek().val
            if t == "[":
                self.next()
                idx = self.expr()
                self.expect("]")
                e = ("idx", e, idx)
            elif t == ".":
                self.next()
                field = self.expect(kind="ident").val
                e = ("mem", e, field)
            else:
                return e

    def _atom(self):
        t = self.next()
        if t.kind == "num":
            return ("num", t.val)
        if t.val == "[":
            elems = []
            if self.peek().val != "]":
                while True:
                    elems.append(self.expr())
                    if not self.accept(","):
                        break
            self.expect("]")
            return ("arr", elems)
        if t.val == "(":
            e = self.expr()
            self.expect(")")
            return e
        if t.kind == "ident" or t.val == "main":
            if self.peek().val == "(":
                self.next()
                args = []
                if self.peek().val != ")":
                    while True:
                        args.append(self.expr())
                        if not self.accept(","):
                            break
                self.expect(")")
                return ("call", t.val, args)
            return ("var", t.val)
        raise SyntaxError(f"unexpected {t.val!r} in expression @{t.pos}")


def parse_circom(src: str):
    return Parser(src).parse_file()
