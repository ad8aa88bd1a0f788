"""bare-except / swallowed-exception: handlers that eat errors silently
(the anti-entropy swallow class).

The motivating bug was a broad ``except`` turning a failed shard poll
into a clean-looking pass — the node reported healthy anti-entropy while
never syncing.  Two rules:

* ``bare-except`` — a bare ``except:`` catches KeyboardInterrupt and
  SystemExit; always name a type.  (Scope ``all``: tests included.)
* ``swallowed-exception`` — an ``except Exception``/``BaseException``
  whose body neither re-raises, uses the bound exception (returning or
  recording it counts), logs (``Logger.event``/``error``/...), counts a
  stat, nor calls an error-accounting helper (``_note_ae_error``,
  ``_mark_down``, ...).  Such a handler makes failure indistinguishable
  from success; make the error observable or carry an inline allow with
  the reason it truly is noise.
"""

from __future__ import annotations

import ast

from ..astlint import rule

BROAD = {"Exception", "BaseException"}

# logging calls make a handler observably handle the error whatever the
# receiver is (log.event, self.logger.error, traceback.print_exc, ...)
_LOG_CALLS = {
    "event", "error", "exception", "warning", "warn", "info", "debug",
    "print_exc", "format_exc",
}
# stat-recording verbs count only on a stats-looking receiver — a bare
# list.count(x) or deque-ish observe() must not read as error accounting
_STAT_CALLS = {
    "count", "incr", "increment", "timing", "gauge", "histogram",
    "observe", "set_value",
}
_STAT_RECEIVERS = ("stat", "hist", "metric")
# snake_case word stems marking error-accounting helpers/slots; matched
# per component (mark_down, _note_ae_error, evict_errors) so unrelated
# words merely CONTAINING a stem (shutdown, discount) don't qualify
_HANDLED_STEMS = ("error", "fail", "down", "quarantine", "reject",
                  "note", "abort")


def _is_broad(type_node) -> bool:
    if type_node is None:
        return False
    nodes = type_node.elts if isinstance(type_node, ast.Tuple) \
        else [type_node]
    for n in nodes:
        name = n.id if isinstance(n, ast.Name) else (
            n.attr if isinstance(n, ast.Attribute) else None)
        if name in BROAD:
            return True
    return False


def _stemmed(name: str) -> bool:
    comps = name.lower().split("_")
    return any(c.startswith(stem) for c in comps for stem in _HANDLED_STEMS)


def _receiver(node) -> str:
    parts = []
    n = node.func.value if isinstance(node.func, ast.Attribute) else None
    while isinstance(n, ast.Attribute):
        parts.append(n.attr)
        n = n.value
    if isinstance(n, ast.Name):
        parts.append(n.id)
    return ".".join(reversed(parts)).lower()


def _handles(handler: ast.ExceptHandler) -> bool:
    bound = handler.name
    for node in ast.walk(ast.Module(body=handler.body, type_ignores=[])):
        if isinstance(node, ast.Raise):
            return True
        if bound and isinstance(node, ast.Name) \
                and isinstance(node.ctx, ast.Load) and node.id == bound:
            return True  # the exception is returned/recorded/re-wrapped
        if isinstance(node, ast.Call):
            name = node.func.attr if isinstance(node.func, ast.Attribute) \
                else (node.func.id if isinstance(node.func, ast.Name)
                      else None)
            if name is None:
                continue
            if name in _LOG_CALLS or _stemmed(name):
                return True
            if name in _STAT_CALLS and any(
                    r in _receiver(node) for r in _STAT_RECEIVERS):
                return True
        if isinstance(node, (ast.Attribute, ast.Name)) \
                and not isinstance(node.ctx, ast.Load):
            # a store into an error-accounting slot counts
            # (self.evict_errors += 1, last_error = ...)
            target = node.attr if isinstance(node, ast.Attribute) \
                else node.id
            if _stemmed(target):
                return True
    return False


@rule("bare-except", scope="all")
def check_bare(mod):
    """Bare ``except:`` swallows KeyboardInterrupt/SystemExit."""
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ExceptHandler) and node.type is None:
            yield node.lineno, ("bare 'except:' catches KeyboardInterrupt/"
                               "SystemExit — name an exception type")


@rule("swallowed-exception", scope="src")
def check_swallow(mod):
    """``except Exception`` body that hides the error entirely."""
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ExceptHandler) and _is_broad(node.type) \
                and not _handles(node):
            yield node.lineno, (
                "except Exception swallows the error invisibly — "
                "re-raise, log (Logger.event/error), count a stat, or "
                "carry an inline allow saying why silence is correct")
