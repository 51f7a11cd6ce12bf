"""Pipeline stages after scene-graph prediction and before it: L2 instance labels, L4 roles and phases."""
