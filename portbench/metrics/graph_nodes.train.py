"""graph_nodes.train: the nodes of the program's captured train step
(`train.graph_nodes`, counted once at capture through the CUDA runtime's
`cudaGraphGetNodes`)."""
from harness import program_spans


def read(rec):
    return program_spans.counter("train.graph_nodes")
