"""Preprocessing (the port's copy of ``fira_tpu/preprocess``): raw diff
token/mark streams -> typed hunks (``fsm``) -> AST and change graphs
(``extract``, on the native astdiff library of ``astdiff_binding``) -> the
corpus files (``pipeline``). Host code only: nothing here imports torch,
so the pipeline's spawned workers start in a fraction of a second."""
