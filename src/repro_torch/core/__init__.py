"""Graph topologies, mixing matrices, partitions and the DecAvg engine."""
