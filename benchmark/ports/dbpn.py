"""DBPN in the program: its build arguments, and the re-layout of the
reference's parameters into the program's state dict and back. The
program names its layers by flax's scheme (`_CB_n` a conv + PReLU,
`_DB_n` a transposed conv + PReLU); the layouts are torch's on both
sides, so the re-layout only renames."""
from benchmark.reference.dbpn import units


def net_type(cfg: dict) -> str:
    return 'DBPN'


def port_args(cfg: dict, h_size: int) -> dict:
    from srcaco2_tpu_torch.config.net_defaults import init_net_g
    args = {'scale': cfg['scale'], 'n_channels': cfg['in_chans'],
            'h_size': h_size, 'amp': cfg['compute_dtype'] == 'bfloat16'}
    netG = init_net_g({'net_type': 'DBPN'}, args)
    netG.update(dbpn_base_filter=cfg['base_filter'], dbpn_feat=cfg['feat'],
                dbpn_num_stages=cfg['num_stages'],
                dbpn_remat_blocks=bool(cfg['remat_blocks']))
    args['netG'] = netG
    return args


def _layers(cfg):
    """(reference layer, program layer, conv kind) of every layer."""
    yield 'feat0', '_CB_0', 'StridedConv_0'
    yield 'feat1', '_CB_1', 'StridedConv_0'
    for name, kind, comp in units():
        n = 0
        if comp:
            yield f'{name}.compress', f'{name}._CB_0', 'StridedConv_0'
            n = 1
        if kind == 'up':
            seq = ('_DB_0', f'_CB_{n}', '_DB_1')
        else:
            seq = (f'_CB_{n}', '_DB_0', f'_CB_{n + 1}')
        for j, sub in enumerate(seq, 1):
            conv = 'ConvT_0' if sub.startswith('_DB') else 'StridedConv_0'
            yield f'{name}.conv{j}', f'{name}.{sub}', conv


def _pairs(cfg):
    for ref, prog, conv in _layers(cfg):
        yield f'{ref}.weight', f'{prog}.{conv}.weight'
        yield f'{ref}.bias', f'{prog}.{conv}.bias'
        yield f'{ref}.act', f'{prog}.PReLU_0.negative_slope'
    yield 'output.weight', 'StridedConv_0.weight'
    yield 'output.bias', 'StridedConv_0.bias'


def to_port(ref: dict, cfg: dict) -> dict:
    return {prog: ref[r].clone() for r, prog in _pairs(cfg)}


def from_port(prog: dict, cfg: dict) -> dict:
    return {r: prog[p] for r, p in _pairs(cfg)}
