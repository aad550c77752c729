"""graph_nodes.render: the nodes of the program's captured render iteration
(`render.graph_nodes`, counted once at capture through the CUDA runtime's
`cudaGraphGetNodes`)."""
from harness import program_spans


def read(rec):
    return program_spans.counter("render.graph_nodes")
