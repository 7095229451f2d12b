"""Cost analysis of the port's steps (``cost``): the counterpart of the
reference's HLO analyzer."""
