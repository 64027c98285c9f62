"""The plain references the runs' answers are judged by.

A CV route finds the reference of each model by name (`harness.references`):
a module here that holds CV models names them in `MODELS` and has

- `solve(X, y, seed, n_replications, n_folds, models, control=False,
  config=None)`: every fold's solutions for the models, in the precision
  the configuration states, or one below it with `control`; `config` is the
  cell's configuration file;
- `compare(records, solution, y)`: the numbers compared, {name: reading},
  `records_differ` among them, of one call's records of its models;
- `records_of_control(solution, y)`: the control's solution as such records;
- `POOLED`: the numbers a run averages over the calls it compares (the
  others take the worst).

The limits of the numbers are the cell's traffic file's `limits`.
"""
