"""Model families: what the harness needs of one family of models, a module
each, found by name.

A configuration file may name its family (`"family": "<name>"`; where it
names none, `arctic_sf`). `spec.family` loads `families/<name>.py` of the
checkout by its path, so a checkout may bring a family of its own; an
unknown name raises and names the families there are. A family is a
module with these functions, every one required (`world` is `run.world`:
given a side's MANO and object-bank dataclasses and a device, the
benchmark's synthetic right and left MANO layers and object bank as that
side's tensors; `loop` is the traffic's, "train" or "eval"):

  - `port(config, world, device, seed, loop)` -> (model, step, optimizer):
    the port's model with the seed's weights (`weights.draw` by the
    configuration's `init` rules, loaded before the optimizer is made), and
    its step built through the port's own entry points, a train step over
    the returned optimizer or an eval step (optimizer None). A train step
    returns the engine's loss dict, an eval step its metric rows.
  - `reference_train(config, world, device, seed, batches, check_steps)`
    -> {"losses", "grad", "update1", "update"}: the plain reference's first
    `check_steps` steps from the same weights, inputs and dropout draws
    (`check.train_numbers` reads them).
  - `reference_eval(config, world, device, seed, batches, ids)` ->
    {id: {metric: (B,) array}}: the reference's rows of the set-up batches
    `ids` (`check.eval_numbers`).
  - `msda_calls(config, batch, loop)` -> [(layers, Lq, P, backward), ...]:
    one entry a kind of MSDA call that a step or eval batch of `batch`
    frames makes, over the configuration's levels (`roofline.
    spatial_shapes`): `layers` such calls, `Lq` queries, `P` points a
    level, the backward with `backward`. `roofline` sums the bound and the
    operations of these, in this order.
  - `flops_model(config, device)`: the plain reference's model with no
    weights, which `roofline.count_flops` counts on the meta device.
  - `make_batches(config, traffic, seed, path)` -> the set-up's batches,
    from inputs that it writes under `path`,
  - `check_batches(batches, traffic, config)`: raises where a batch is not
    of the traffic's shape,
  - `data_numbers(batches, path, config, traffic, seed)` -> {name: gap}:
    the set-up's batches against a plain reading of their inputs.
A family that reads ARCTIC as `arctic_sf` does imports these three from
`arctic_sf`.

What stays in `run.py` for every family: the weights' rules and draws
(`weights.py`), the faults (`run.with_fault` under the step; `group_rate`
on the optimizer's `linear_proj` group where it has one), the window, the
trace and the judgement (`check.judge`).

A family's plain reference lives under `reference/` or beside its module
here and imports nothing of the port; its module imports the port only
inside the functions that build the port's side.
"""
