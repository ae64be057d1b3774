from .node import (Op, PlaceholderOp, VariableOp, find_topo_sort,
                   graph_variables, name_scope, scoped_init)
from .trace import TraceContext, evaluate
from .autodiff import gradients
from .executor import CaptureError, Executor, SubExecutor, disable_capture
