from .builder import Expr, GraphBuilder  # noqa: F401
from .graph import Constant, Graph, Node, NodeId, Operator, Value  # noqa: F401
