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

A reference that judges a Gibbs chain by its states declares `CHAIN = True`
(`bayes.py`). For each checked call the route re-runs the call with each of
its models alone, the program's chain driven in one-sweep segments, and
counts `rerun_differs` (records of the re-run not bit-identical to the
window's) and `chain_unreachable` (a model whose chain it could not reach).
Such a reference's `solve` also takes `chain={model: chain}`, what it
conditions on, or None for a chain not reached:

- `steps`: [{"t": sweep, "before": state}] for the sweeps it replays (the
  first, and two drawn from the seed, one in burn-in and one after), the
  state before the sweep;
- `post_b` (T, F, p_pad) and `post_mu` (T, F): b and the centred intercept
  after every sweep from the configured burn-in on, on the device;

a state being {b, r, s2, sig_e2, mu, pi} as tensors with a leading fold axis
and `gens`, each fold's generator state. The program's own results go into
that call's records under `chain`: {"n_sweeps": the sweeps it ran, "steps":
[{"t": sweep, "after": state}]}; `records_of_control` builds the same from
the control's replay. A reference without `CHAIN` is called as above.

The limits of the numbers are the cell's traffic file's `limits`.
"""
