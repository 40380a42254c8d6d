from .generators import (  # noqa: F401
    erdos_renyi,
    erdos_renyi_edges,
    preferential_attachment,
    preferential_attachment_edges,
    random_degree_graph,
    random_degree_graph_edges,
    random_weights,
    random_weights_edges,
    specialized_geometric,
    specialized_geometric_edges,
)
