from .graph_builder import add_knn_bonds, add_radius_bonds, structure_to_graph
