from .cluster import Cluster
