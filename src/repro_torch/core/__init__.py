"""Engine core of the port: quorums, schedules, placements, the comm layer,
the pair-sweep runtime and the dense all-pairs engine."""
